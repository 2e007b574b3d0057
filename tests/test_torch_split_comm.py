"""The collectives of a split that crosses processes, in one process:
ranks are threads and their group a stand-in (:class:`_ThreadGroup`) with
the collectives of :class:`relayrl_tpu_torch.parallel.distributed.
AxisGroup`, as ``tests/test_torch_distributed.py``'s ``_QueueHop`` stands
in for the ring's hop.

* a split parameter's gather (``sharding._Gather``): forward the blocks
  joined in rank order; backward the ``torch.cat`` backward of the whole,
  summed over the ranks (fsdp, whose ranks hold other rows) or this
  rank's slice (ep, tp, whose ranks computed the same gradient); several
  parameters gathered in one all-gather (``sharding._gather_bucket``),
  each with its own backward;
* f and g (``context.enter_split``, ``context.leave_split``): the
  gradient of f's input and g's output are the single-process sums;
* the tp MLP pair and the MoE layer with their work split over two
  thread-ranks: outputs and gradients equal the single-process layer's
  within 1e-6 (f32; the partial sums add in another order);
* ``context.dp_gradients`` sums a shard that the fsdp gather summed over
  the dp group alone.

Every value is exact or within the stated bar; nothing here starts a
process group.
"""

import threading

import pytest
import torch

from relayrl_tpu_torch.parallel import context
from relayrl_tpu_torch.parallel.sharding import _Gather

TOL = 1e-6  # f32, the partial sums of two ranks added in another order


class _ThreadGroup:
    """``size`` threads' group: each collective waits for every member's
    contribution (a barrier), then each reads what it needs."""

    def __init__(self, shared, rank):
        self.shared, self.rank, self.size = shared, rank, shared["size"]

    def _exchange(self, t):
        slots, barrier = self.shared["slots"], self.shared["barrier"]
        slots[self.rank] = t.detach().clone()
        barrier.wait(timeout=60)
        got = [slots[r].clone() for r in range(self.size)]
        barrier.wait(timeout=60)
        return got

    def all_gather(self, t):
        return self._exchange(t)

    def all_reduce(self, flat):
        total = None
        for t in self._exchange(flat):
            total = t if total is None else total + t
        flat.copy_(total)
        return flat

    def reduce_scatter(self, chunks):
        flat = torch.cat([c.reshape(-1) for c in chunks])
        n = chunks[self.rank].numel()
        return self.all_reduce(flat)[self.rank * n:(self.rank + 1) * n].reshape(
            chunks[self.rank].shape)


def _run_ranks(size, fn):
    """``fn(group)`` on ``size`` threads, one a rank; their results by rank."""
    shared = {"size": size, "slots": [None] * size,
              "barrier": threading.Barrier(size)}
    out, errors = {}, []

    def main(rank):
        try:
            out[rank] = fn(_ThreadGroup(shared, rank))
        except Exception as e:  # reported by the assert below
            errors.append(e)
            shared["barrier"].abort()

    threads = [threading.Thread(target=main, args=(r,)) for r in range(size)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors and not any(t.is_alive() for t in threads), errors
    return [out[r] for r in range(size)]


@pytest.mark.parametrize("dim", [0, 1])
@pytest.mark.parametrize("summed", [True, False])
def test_gather_and_its_backward(dim, summed):
    """Each rank's block joins whole in rank order; the backward gives
    each rank the sum of every rank's gradient at its block (summed), or
    its own gradient at its block."""
    gen = torch.Generator().manual_seed(0)
    whole = torch.randn(4, 6, generator=gen)
    # Each rank's upstream gradient of the whole (other rows: another).
    ups = [torch.randn(4, 6, generator=gen) for _ in range(2)]
    blocks = whole.chunk(2, dim=dim)

    def rank_fn(group):
        leaf = blocks[group.rank].clone().requires_grad_()
        got = _Gather.apply(leaf, dim, group, summed)
        (got * ups[group.rank]).sum().backward()
        return got.detach(), leaf.grad

    outs = _run_ranks(2, rank_fn)
    for rank, (got, grad) in enumerate(outs):
        assert torch.equal(got, whole)
        own = [u.chunk(2, dim=dim)[rank] for u in ups]
        assert torch.equal(grad, own[0] + own[1] if summed else own[rank])


def test_bucketed_gather_and_per_parameter_backward():
    """Three parameters' blocks (split along dims 0, 1, 0) joined whole in
    one all-gather; a loss of one of them sends its summed gradient to
    that parameter's block alone (the others take none): the backward is
    each parameter's own reduce-scatter."""
    from types import SimpleNamespace

    from relayrl_tpu_torch.parallel.sharding import _gather_bucket

    gen = torch.Generator().manual_seed(3)
    wholes = [torch.randn(4, 6, generator=gen), torch.randn(3, 8, generator=gen),
              torch.randn(2, 5, generator=gen)]
    dims = (0, 1, 0)
    ups = [torch.randn(3, 8, generator=gen) for _ in range(2)]
    spec = SimpleNamespace(spec=("fsdp", "fsdp"))

    def rank_fn(group):
        leaves = [w.chunk(2, dim=d)[group.rank].clone().requires_grad_()
                  for w, d in zip(wholes, dims)]
        got = _gather_bucket(group, [(spec, d, b) for d, b in zip(dims, leaves)])
        (got[1] * ups[group.rank]).sum().backward()
        return [g.detach() for g in got], [b.grad for b in leaves]

    for rank, (got, grads) in enumerate(_run_ranks(2, rank_fn)):
        assert all(torch.equal(g, w) for g, w in zip(got, wholes))
        assert grads[0] is None and grads[2] is None
        assert torch.equal(grads[1], ups[0].chunk(2, 1)[rank] + ups[1].chunk(2, 1)[rank])


def test_enter_and_leave_split():
    """f's input gradient and g's output are the sums over the ranks."""
    x = torch.arange(6.0).reshape(2, 3)

    def rank_fn(group):
        leaf = x.clone().requires_grad_()
        y = context.enter_split(leaf, group) * (group.rank + 1.0)
        z = context.leave_split(y, group)
        z.sum().backward()
        return z.detach(), leaf.grad

    for z, grad in _run_ranks(2, rank_fn):
        assert torch.equal(z, 3.0 * x)
        # Each rank's partial gradient of x is its factor; f sums them.
        assert torch.equal(grad, torch.full_like(x, 3.0))
    assert context.enter_split(x, None) is x and context.leave_split(x, None) is x


def _blocks_of(weight, bias, down, parts):
    """tp blocks of the pair: rows of the up kernel and bias, columns of
    the down kernel."""
    return list(zip(weight.chunk(parts, 0), bias.chunk(parts, 0), down.chunk(parts, 1)))


def test_tp_pair_split_over_ranks_matches_one_process():
    """The column-then-row-parallel pair, one tp block a thread-rank,
    against the single-process pair over both blocks: output and every
    gradient (the input's summed by f) within the bar."""
    from relayrl_tpu_torch.models.mlp import MLPTrunk

    gen = torch.Generator().manual_seed(1)
    trunk = MLPTrunk(5, (8, 6), "tanh", torch.float32)
    for p in trunk.parameters():
        with torch.no_grad():
            p.copy_(torch.randn(p.shape, generator=gen))
    x = torch.randn(3, 5, generator=gen)
    cpu = torch.device("cpu")

    def run(group, rank, parts):
        w = trunk.dense_0.weight.detach().clone().requires_grad_()
        b = trunk.dense_0.bias.detach().clone().requires_grad_()
        d = trunk.dense_1.weight.detach().clone().requires_grad_()
        xin = x.clone().requires_grad_()
        blocks = _blocks_of(w, b, d, 2)
        mine = blocks if group is None else [blocks[rank]]
        blocks = [((cpu, wb), (cpu, bb), (cpu, db)) for wb, bb, db in mine]
        y = trunk._tp_pair(xin, trunk.dense_1, blocks, group)
        y.pow(2).sum().backward()
        return y.detach(), xin.grad, w.grad, b.grad, d.grad

    want = run(None, 0, 2)
    outs = _run_ranks(2, lambda group: run(group, group.rank, 1))
    for rank, got in enumerate(outs):
        torch.testing.assert_close(got[0], want[0], rtol=0, atol=TOL)
        torch.testing.assert_close(got[1], want[1], rtol=0, atol=TOL)
        # Each rank's gradients of its block's rows (and the down
        # kernel's columns); zeros elsewhere.
        for k, dim in ((2, 0), (3, 0), (4, 1)):
            torch.testing.assert_close(got[k].chunk(2, dim)[rank],
                                       want[k].chunk(2, dim)[rank], rtol=0, atol=TOL)
    torch.testing.assert_close(outs[0][2] + outs[1][2], want[2], rtol=0, atol=TOL)


def test_moe_split_over_ranks_matches_one_process(monkeypatch):
    """The MoE layer with its 4 experts split 2 a thread-rank (the stand-in
    blocks of ``split_blocks``) against the dense single-process layer:
    output, the input's and the gate's gradients within the bar, each
    rank's expert gradients its experts' (f32)."""
    from relayrl_tpu_torch.models import moe as moe_mod
    from relayrl_tpu_torch.parallel.sharding import Blocks

    gen = torch.Generator().manual_seed(2)
    layer = moe_mod.MoEMLP(6, 8, 4, 2, torch.float32)
    for p in layer.parameters():
        with torch.no_grad():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.5)
    x = torch.randn(2, 3, 6, generator=gen)
    cpu = torch.device("cpu")

    own = threading.local()

    def blocks(owner, leaf, axis):
        group = getattr(own, "group", None)
        if group is None:
            return None
        stack = getattr(owner, leaf)
        return Blocks([(cpu, stack[2 * group.rank:2 * group.rank + 2])], group.rank,
                      2, group)

    monkeypatch.setattr(moe_mod, "split_blocks", blocks)

    def run(group):
        own.group = group
        lay = moe_mod.MoEMLP(6, 8, 4, 2, torch.float32)
        lay.load_state_dict(layer.state_dict())
        xin = x.clone().requires_grad_()
        y = lay(xin)
        y.pow(2).sum().backward()
        return (y.detach(), xin.grad, lay.moe_gate.weight.grad, lay.moe_w_up.grad,
                lay.moe_w_down.grad)

    want = run(None)
    outs = _run_ranks(2, run)
    for rank, got in enumerate(outs):
        for k in range(3):
            torch.testing.assert_close(got[k], want[k], rtol=0, atol=TOL)
        for k in (3, 4):
            mine = slice(2 * rank, 2 * rank + 2)
            torch.testing.assert_close(got[k][mine], want[k][mine], rtol=0, atol=TOL)
            assert not got[k][2 - 2 * rank:4 - 2 * rank].any()


def test_dp_gradients_sum_fsdp_summed_shards_over_dp_alone():
    """Under a data group whose ``dp`` group is set, a parameter marked
    ``summed_over_fsdp`` is summed over the dp group only, the others over
    the whole data group (stand-ins that scale by their size)."""

    class _Scale:
        def __init__(self, rank, size, dp=None):
            self.rank, self.size, self.dp = rank, size, dp

        def all_reduce(self, flat):
            return flat.mul_(self.size)

    w = torch.ones(3, requires_grad=True)
    shard = torch.ones(2, requires_grad=True)
    shard.summed_over_fsdp = True
    with context.use_dp_group(_Scale(1, 4, _Scale(0, 2))):
        gw, gs = context.dp_gradients((w * 3).sum() + (shard * 5).sum(), [w, shard])
    assert torch.equal(gw, torch.full((3,), 12.0))
    assert torch.equal(gs, torch.full((2,), 10.0))
    with context.use_dp_group(_Scale(1, 2)):
        # fsdp crosses, dp does not: the shard's reduce-scatter was its sum.
        gw, gs = context.dp_gradients((w * 3).sum() + (shard * 5).sum(), [w, shard])
    assert torch.equal(gw, torch.full((3,), 6.0)) and torch.equal(gs, torch.full((2,), 5.0))


def test_split_comm_counts_reset():
    from relayrl_tpu_torch.parallel import distributed

    distributed.COMM.gathers = 3
    distributed.COMM.reset()
    assert distributed.COMM.as_dict() == {
        "gathers": 0, "gather_bytes": 0, "scatters": 0, "scatter_bytes": 0,
        "deferred": 0, "reduces": 0, "reduce_bytes": 0, "gather_seconds": 0.0,
        "scatter_seconds": 0.0, "reduce_seconds": 0.0}


def _defer_bucketed_reduce_scatters(device):
    from types import SimpleNamespace

    from relayrl_tpu_torch.parallel.sharding import _gather_bucket

    gen = torch.Generator().manual_seed(5)
    wholes = [torch.randn(4, 6, generator=gen), torch.randn(8, 3, generator=gen)]
    ups = [[torch.randn(4, 6, generator=gen), torch.randn(8, 3, generator=gen)]
           for _ in range(2)]
    spec = SimpleNamespace(spec=("fsdp", None))

    def rank_fn(group):
        order = []
        scatter = group.reduce_scatter

        def logged(chunks):
            # Held back from the engine: no autograd node is running now.
            order.append((tuple(chunks[0].shape), torch._C._current_autograd_node() is None))
            return scatter(chunks)

        group.reduce_scatter = logged
        first = wholes[0].chunk(2)[group.rank].to(device).requires_grad_()
        second = [c.to(device).requires_grad_() for c in wholes[1].chunk(4)[2 * group.rank:
                                                                           2 * group.rank + 2]]
        got = _gather_bucket(group, [(spec, 0, first),
                                     (spec, 0, torch.cat(second), (second, [(0, 2)]))])
        up = [u.to(device) for u in ups[group.rank]]
        # The second parameter's gradient first in the engine's order.
        loss = (got[0] * up[0]).sum() + (got[1] * up[1]).sum() * torch.ones((), device=device)
        grads = context.dp_gradients(loss, [first, *second])
        return order, [g.device for g in grads], [g.cpu() for g in grads]

    for rank, (order, devices, grads) in enumerate(_run_ranks(2, rank_fn)):
        assert order == [((2, 6), True), ((4, 3), True)]
        assert devices == [device] * 3
        total = [ups[0][k] + ups[1][k] for k in range(2)]
        assert torch.equal(grads[0], total[0].chunk(2)[rank])
        mine = total[1].chunk(4)[2 * rank:2 * rank + 2]
        assert torch.equal(grads[1], mine[0]) and torch.equal(grads[2], mine[1])


def test_dp_gradients_defer_bucketed_reduce_scatters():
    """Inside ``dp_gradients`` a bucketed gather's reduce-scatter waits for
    the autograd engine, then runs in the order of the forward's gathers
    (whatever order the engine reached them in), and its block's gradient
    is cut back onto the shards the block was joined from: one parameter
    held as a leaf block, one as a block joined from two shards. Each
    rank's gradients are the sums over the ranks at its blocks."""
    _defer_bucketed_reduce_scatters(torch.device("cpu"))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the autograd engine runs a CUDA "
                    "tensor's backward on its device thread only on a card")
    return torch.device("cuda", torch.cuda.current_device())


def test_dp_gradients_defer_bucketed_reduce_scatters_on_cuda(cuda_device):
    """The same on CUDA tensors, whose backward nodes the autograd engine
    runs on its device thread unless ``dp_gradients`` keeps them on the
    calling thread: there the reduce-scatters would not be held back (that
    thread does not see the caller's held list) and the two thread-ranks'
    would wait on each other on the one device thread."""
    _defer_bucketed_reduce_scatters(cuda_device)
