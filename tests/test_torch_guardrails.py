"""The port's training-health guardrails against the JAX package's.

Class by class after ``tests/test_guardrails.py`` and
``tests/test_guardrails_fuzz.py``, on the same numpy inputs through both
packages:

* validator reasons, rejection counting, quarantine, admission and the
  watchdog give the JAX package's verdicts (exact);
* ``GuardProbes`` on params carried across by ``weights.py`` give JAX's
  values: the nonfinite count exactly, the param and update norms to
  ``PROBE_NORM_RTOL`` (float32 sums in a different order), and a probe
  costs a fixed number of non-view operations whatever the number of
  leaves;
* config defaults, the healthy checkpoint ring, the spool's typed nacks,
  the server's ingest guard, the publish gate and rollback;
* one stream (clean, NaN, wrong shape, over-length) fed into a JAX server
  and a port server gives equal per-reason counts, strikes, quarantine
  verdicts and ``guardrails_accounting()``, and after ``trip_external``
  both roll back to the same checkpoint step;
* params are bit-identical with probes on and off (CPU).

Models are ``mlp_discrete`` 8 or 16 wide and a 1-layer transformer, so
every update takes milliseconds.
"""

import json
import math
import time

import numpy as np
import pytest

from relayrl_tpu import guardrails as jax_guard
from relayrl_tpu import telemetry as jax_telemetry
from relayrl_tpu.guardrails import validate as jax_validate
from relayrl_tpu.runtime import spool as jax_spool
from relayrl_tpu.transport import base as jax_base
from relayrl_tpu.types import action as jax_action
from relayrl_tpu.types import columnar as jax_columnar
from relayrl_tpu.types import trajectory as jax_trajectory
from relayrl_tpu_torch import guardrails as port_guard
from relayrl_tpu_torch import telemetry as port_telemetry
from relayrl_tpu_torch.guardrails import validate as port_validate
from relayrl_tpu_torch.guardrails.watchdog import (
    PROBE_NONFINITE,
    PROBE_PARAM_NORM,
    PROBE_UPDATE_NORM,
)
from relayrl_tpu_torch.runtime import spool as port_spool
from relayrl_tpu_torch.transport import base as port_base
from relayrl_tpu_torch.types import action as port_action
from relayrl_tpu_torch.types import columnar as port_columnar
from relayrl_tpu_torch.types import trajectory as port_trajectory

OBS_DIM, ACT_DIM = 4, 2
# Probe norms: float32 sums of squares over the same leaves in another
# order (JAX per leaf then a Python sum; the port over one flat vector).
PROBE_NORM_RTOL = 1e-5

PKGS = {
    "jax": {"guard": jax_guard, "validate": jax_validate,
            "action": jax_action, "columnar": jax_columnar,
            "trajectory": jax_trajectory, "spool": jax_spool,
            "base": jax_base, "telemetry": jax_telemetry},
    "port": {"guard": port_guard, "validate": port_validate,
             "action": port_action, "columnar": port_columnar,
             "trajectory": port_trajectory, "spool": port_spool,
             "base": port_base, "telemetry": port_telemetry},
}


@pytest.fixture(autouse=True)
def _clean_telemetry():
    for mod in (jax_telemetry, port_telemetry):
        mod.reset_for_tests()
    yield
    for mod in (jax_telemetry, port_telemetry):
        mod.reset_for_tests()


def _episode(pkg, n=4, seed=0, rew=None, obs_fill=None, with_v=True):
    """``tests/test_guardrails.py::_episode`` in ``pkg``'s record type."""
    ActionRecord = PKGS[pkg]["action"].ActionRecord
    rng = np.random.default_rng(seed)
    recs = []
    for i in range(n):
        data = {"logp_a": np.float32(-0.69)}
        if with_v:
            data["v"] = np.float32(rng.standard_normal())
        obs = (np.full((OBS_DIM,), obs_fill, np.float32)
               if obs_fill is not None
               else rng.standard_normal(OBS_DIM).astype(np.float32))
        recs.append(ActionRecord(
            obs=obs, act=np.int64(rng.integers(ACT_DIM)),
            rew=float(rew) if (rew is not None and i == n - 1)
            else float(rng.random()),
            data=data, done=(i == n - 1)))
    return recs


def _decoded(pkg, rew=1.0, n=2, agent="a"):
    return PKGS[pkg]["columnar"].DecodedTrajectory(
        agent_id=agent, n_steps=n, n_records=n, marker_truncated=False,
        columns={"o": np.zeros((n, OBS_DIM), np.float32),
                 "a": np.zeros((n,), np.int32),
                 "r": np.array([0.0] * (n - 1) + [rew], np.float32),
                 "t": np.array([False] * (n - 1) + [True]),
                 "u": np.zeros((n,), np.uint8),
                 "x": np.zeros((n,), np.uint8)},
        aux={"v": np.zeros((n,), np.float32),
             "logp_a": np.zeros((n,), np.float32)})


def _replace_record(pkg, recs, i, **fields):
    ActionRecord = PKGS[pkg]["action"].ActionRecord
    rec = recs[i]
    base = dict(obs=rec.obs, act=rec.act, rew=rec.rew, data=rec.data,
                done=rec.done)
    base.update(fields)
    recs[i] = ActionRecord(**base)
    return recs


def _both(build):
    """``build(pkg)`` for each package -> the two validator verdicts."""
    return {pkg: PKGS[pkg]["validate"].validate_trajectory(*build(pkg))
            for pkg in PKGS}


# ---------------------------------------------------------------------------
# validate.py
# ---------------------------------------------------------------------------
def _hostile(pkg):
    class Hostile:
        def __len__(self):
            return 2

        def __iter__(self):
            raise RuntimeError("weaponized payload")

    return (Hostile(),)


def _shape_mismatch(pkg):
    item = _decoded(pkg, n=3)
    item.columns["r"] = np.zeros((2,), np.float32)
    return (item,)


def _object_column(pkg):
    item = _decoded(pkg)
    item.aux["v"] = np.array([object(), object()], dtype=object)
    return (item,)


def _list_column(pkg):
    item = _decoded(pkg)
    item.columns["o"] = [[0.0] * OBS_DIM, [0.0] * OBS_DIM]
    return (item,)


def _bf16_nan(pkg):
    import ml_dtypes

    recs = _episode(pkg)
    bad = np.array([0.1, float("nan"), 0.2, 0.3], ml_dtypes.bfloat16)
    return (_replace_record(pkg, recs, 1, obs=bad),)


VALIDATOR_CASES = {
    "clean_records": (lambda p: (_episode(p),), None),
    "clean_decoded": (lambda p: (_decoded(p),), None),
    "nan_reward": (lambda p: (_episode(p, rew=float("nan")),), "nonfinite"),
    "inf_reward": (lambda p: (_episode(p, rew=float("inf")),), "nonfinite"),
    "nan_obs": (lambda p: (_episode(p, obs_fill=float("nan")),),
                "nonfinite"),
    "nan_decoded": (lambda p: (_decoded(p, rew=float("nan")),),
                    "nonfinite"),
    "non_record_items": (lambda p: (["not-a-record"],), "schema"),
    "not_a_sequence": (lambda p: (object(),), "schema"),
    "string_reward": (lambda p: (_replace_record(p, _episode(p), 0,
                                                 rew="1.0"),), "schema"),
    "object_obs": (lambda p: (_replace_record(
        p, _episode(p), 0, obs=np.array([object()], dtype=object),
        rew=0.0),), "dtype"),
    "string_aux_inert": (lambda p: (_replace_record(
        p, _episode(p), 0, rew=0.0,
        data={"tag": "ep-1", "v": np.float32(0.1),
              "logp_a": np.float32(-0.1)}),), None),
    "over_length": (lambda p: (_episode(p, n=8), 4), "length"),
    "at_length": (lambda p: (_episode(p, n=4), 4), None),
    "length_bound_off": (lambda p: (_episode(p, n=8), 0), None),
    "decoded_shape": (_shape_mismatch, "shape"),
    "decoded_object_column": (_object_column, "dtype"),
    "decoded_list_column": (_list_column, "schema"),
    "hostile": (_hostile, "validator_error"),
    "bfloat16_nan": (_bf16_nan, "nonfinite"),
}


class TestValidator:
    @pytest.mark.parametrize("case", sorted(VALIDATOR_CASES))
    def test_reason_matches_reference(self, case):
        build, want = VALIDATOR_CASES[case]
        got = _both(build)
        assert got == {"jax": want, "port": want}, case

    def test_reasons_vocabulary(self):
        assert port_validate.REASONS == jax_validate.REASONS

    def test_trajectory_reward_both_shapes(self):
        for pkg in PKGS:
            reward = PKGS[pkg]["validate"].trajectory_reward
            recs = _episode(pkg, rew=2.0, n=3)
            assert reward(recs) == pytest.approx(sum(r.rew for r in recs))
            assert reward(_decoded(pkg, rew=3.0)) == pytest.approx(3.0)
            assert reward(object()) is None

    @pytest.mark.parametrize("leaf,want", [
        (np.ones((3,), np.float32), True),
        (np.int32(7), True),
        (np.array([1.0, float("nan")], np.float32), False),
        (np.array([np.inf], np.float32), False),
    ])
    def test_params_tree_finite_numpy(self, leaf, want):
        tree = {"params": {"dense_0": {"kernel": leaf}}}
        assert port_validate.params_tree_finite(tree) is want
        assert jax_validate.params_tree_finite(tree) is want

    def test_params_tree_finite_tensors_and_bfloat16(self):
        import ml_dtypes
        import torch

        assert port_validate.params_tree_finite(
            {"w": torch.ones(3), "step": torch.tensor(7)})
        assert not port_validate.params_tree_finite(
            {"w": [torch.tensor([1.0, float("nan")])]})
        assert not port_validate.params_tree_finite(
            {"w": torch.tensor([float("inf")], dtype=torch.bfloat16)})
        bf16 = np.array([1.0, float("nan")], ml_dtypes.bfloat16)
        assert not port_validate.params_tree_finite({"w": bf16})
        assert not jax_validate.params_tree_finite({"w": bf16})


class TestValidatorFuzz:
    """``tests/test_guardrails_fuzz.py``'s contract on seeded random
    inputs (no hypothesis): the verdicts of the two packages agree, never
    raise, and stay inside the reason vocabulary."""

    @pytest.mark.parametrize("seed", range(4))
    def test_random_records_agree(self, seed):
        rng = np.random.default_rng(seed)
        specials = [float("nan"), float("inf"), -float("inf"), 0.0, 1e30]
        for _ in range(40):
            n = int(rng.integers(0, 7))
            sub_seed = int(rng.integers(1 << 30))
            verdicts = {}
            for pkg in PKGS:
                sub = np.random.default_rng(sub_seed)
                recs = _episode(pkg, n=max(n, 1), seed=seed)
                for i in range(len(recs)):
                    if sub.random() < 0.2:
                        recs = _replace_record(
                            pkg, recs, i,
                            rew=specials[int(sub.integers(len(specials)))])
                verdicts[pkg] = PKGS[pkg]["validate"].validate_trajectory(
                    recs[:n] if n else recs, 5)
            assert verdicts["jax"] == verdicts["port"]
            assert verdicts["port"] in (None,) + port_validate.REASONS


# ---------------------------------------------------------------------------
# the Guardrails facade
# ---------------------------------------------------------------------------
def _params(pkg, tmp_path=None, **over):
    from relayrl_tpu.config.loader import ConfigLoader as JaxLoader
    from relayrl_tpu_torch.config import ConfigLoader as PortLoader

    loader = (JaxLoader if pkg == "jax" else PortLoader)(
        "REINFORCE", None, create_if_missing=False)
    params = loader.get_guardrails_params()
    params.update(over)
    return params


class TestRejectionCounting:
    def test_every_rejection_reason_is_counted(self):
        rows = {}
        for pkg, mods in PKGS.items():
            tel = mods["telemetry"]
            tel.set_registry(tel.Registry(run_id=f"guard-{pkg}"))
            g = mods["guard"].Guardrails(_params(pkg, max_steps=4))
            rejects = [_episode(pkg, rew=float("nan")), _episode(pkg, n=9),
                       ["junk"], object()]
            for item in rejects:
                assert g.validate("fuzzer", item) is None
            snap = tel.get_registry().snapshot()
            rows[pkg] = sorted(
                (m["labels"]["reason"], m["value"]) for m in snap["metrics"]
                if m["name"] == "relayrl_guard_rejected_total")
        assert rows["port"] == rows["jax"]
        assert sum(v for _, v in rows["port"]) == 4

    @pytest.mark.parametrize("mode", ["off", "warn", "enforce"])
    def test_validation_mode_feeds_reward_detector(self, mode):
        for pkg, mods in PKGS.items():
            g = mods["guard"].Guardrails(_params(
                pkg, reward_collapse_drop=5.0, ingest_validation=mode))
            assert g.validate("a", _episode(pkg)) is not None
            assert len(g.watchdog._rewards) == 1, (pkg, mode)

    def test_warn_mode_admits_but_strikes(self):
        for pkg, mods in PKGS.items():
            g = mods["guard"].Guardrails(_params(
                pkg, ingest_validation="warn", strike_threshold=100))
            assert g.validate("a", _episode(pkg, rew=float("nan"))) \
                is not None
            assert g.quarantine.accounting()["strikes_pending"] == {"a": 1}


# ---------------------------------------------------------------------------
# quarantine.py, admission.py: the same scenario through both packages
# ---------------------------------------------------------------------------
@pytest.fixture(params=sorted(PKGS))
def pkg(request):
    return request.param


class TestQuarantine:
    def test_below_threshold_stays_clean(self, pkg):
        book = PKGS[pkg]["guard"].QuarantineBook(strike_threshold=3)
        assert book.strike("a", "nonfinite") is False
        assert book.strike("a", "nonfinite") is False
        assert not book.is_quarantined("a")

    def test_threshold_quarantines(self, pkg):
        book = PKGS[pkg]["guard"].QuarantineBook(
            strike_threshold=2, strike_window_s=60, cooldown_s=300)
        assert book.strike("a", "nonfinite") is False
        assert book.strike("a", "nonfinite") is True
        assert book.is_quarantined("a") and not book.is_quarantined("b")
        assert 0 < book.retry_after("a") <= 300
        assert book.retry_after("b") == 0.0

    def test_strikes_age_out_and_parole(self, pkg):
        Book = PKGS[pkg]["guard"].QuarantineBook
        book = Book(strike_threshold=2, strike_window_s=0.05)
        book.strike("a", "nonfinite")
        time.sleep(0.08)
        assert book.strike("a", "nonfinite") is False
        book = Book(strike_threshold=1, cooldown_s=0.05)
        assert book.strike("a", "nonfinite") is True
        time.sleep(0.08)
        assert not book.is_quarantined("a")
        assert book.paroles_total == 1
        assert book.strike("a", "nonfinite") is True

    def test_accounting_matches_reference(self):
        out = {}
        for pkg, mods in PKGS.items():
            book = mods["guard"].QuarantineBook(strike_threshold=2)
            book.strike("a", "nonfinite")
            book.strike("b", "schema")
            book.strike("b", "schema")
            out[pkg] = book.accounting()
        assert out["port"] == out["jax"] == {
            "quarantined": ["b"], "quarantines_total": 1,
            "paroles_total": 0, "strikes_pending": {"a": 1}}


class TestAdmission:
    def _run(self, pkg, script, **kw):
        adm = PKGS[pkg]["guard"].AdmissionController(**kw)
        verdicts = []
        for op, agent in script:
            if op == "admit":
                verdicts.append(adm.admit(agent))
            elif op == "enq":
                adm.note_enqueued(agent)
            else:
                adm.note_dequeued(agent)
        return verdicts, adm.accounting(), adm.agent_cap

    @pytest.mark.parametrize("kw,script", [
        ({"soft_limit": 4}, [("admit", "a"), ("enq", "a")]),
        ({"soft_limit": 10, "agent_share": 0.2},
         [("admit", "hog"), ("enq", "hog"), ("admit", "hog"),
          ("enq", "hog"), ("admit", "hog"), ("admit", "polite")]),
        ({"soft_limit": 2, "policy": "drop_oldest", "agent_share": 1.0},
         [("admit", "a"), ("enq", "a"), ("admit", "b"), ("enq", "b"),
          ("admit", "c"), ("deq", "a"), ("enq", "c")]),
        ({"soft_limit": 1, "policy": "nack", "agent_share": 1.0,
          "retry_after_s": 2.5},
         [("admit", "a"), ("enq", "a"), ("admit", "b"), ("deq", "a"),
          ("admit", "b")]),
        ({"soft_limit": 3, "policy": "bogus", "agent_share": 7.0},
         [("admit", "a"), ("enq", "a")]),
    ], ids=["under_limit", "fair_share", "drop_oldest", "nack", "clamped"])
    def test_verdicts_match_reference(self, kw, script):
        jax_out = self._run("jax", script, **kw)
        port_out = self._run("port", script, **kw)
        assert port_out == jax_out
        assert port_guard.SHED_POLICIES == jax_guard.SHED_POLICIES


# ---------------------------------------------------------------------------
# watchdog.py: detectors (both packages) and the torch probes
# ---------------------------------------------------------------------------
WATCHDOG_SCRIPTS = {
    "nonfinite_probe": ({}, [("dispatch", 1, {PROBE_NONFINITE: 3.0,
                                              PROBE_PARAM_NORM: 1.0}),
                             ("poll", 1)]),
    "param_norm": ({"max_param_norm": 10.0},
                   [("dispatch", 1, {PROBE_NONFINITE: 0.0,
                                     PROBE_PARAM_NORM: 5.0}),
                    ("poll", 1),
                    ("dispatch", 2, {PROBE_NONFINITE: 0.0,
                                     PROBE_PARAM_NORM: 50.0}),
                    ("poll", 2)]),
    "param_norm_inf": ({}, [("dispatch", 1,
                             {PROBE_PARAM_NORM: float("inf")}),
                            ("poll", 1)]),
    "update_norm": ({"max_update_norm": 1.0},
                    [("dispatch", 1, {PROBE_UPDATE_NORM: 4.2}),
                     ("poll", 1)]),
    "loss_nonfinite": ({}, [("dispatch", 1, {"LossPi": float("nan")}),
                            ("poll", 1)]),
    "loss_spike": ({"loss_spike_factor": 3.0, "loss_window": 4},
                   [("dispatch", 1, {"LossPi": 1.0}), ("poll", 1),
                    ("dispatch", 2, {"LossPi": 1.1}), ("poll", 2),
                    ("dispatch", 3, {"LossPi": 0.9}), ("poll", 3),
                    ("dispatch", 4, {"LossPi": 10.0}), ("poll", 4)]),
    "reward_collapse": ({"reward_collapse_drop": 5.0, "reward_window": 4},
                        [("reward", 10.0)] * 4 + [("poll", 0)]
                        + [("reward", 0.0)] * 4 + [("poll", 0)]),
    "fence_gating": ({}, [("dispatch", 5, {PROBE_NONFINITE: 1.0}),
                          ("poll", 4), ("poll", 5)]),
    "external": ({}, [("external", "publish_nonfinite"), ("poll", 0),
                      ("poll", 0)]),
    "pending_unhealthy": ({}, [("dispatch", 1, {PROBE_NONFINITE: 1.0}),
                               ("poll", 0), ("poll", 1)]),
    "rearm": ({"loss_spike_factor": 3.0, "loss_window": 4,
               "reward_collapse_drop": 1.0, "reward_window": 4},
              [("dispatch", 1, {PROBE_NONFINITE: 1.0}), ("poll", 1),
               ("reset",), ("dispatch", 2, {"LossPi": 1.0}), ("poll", 2)]),
}


def _run_watchdog(pkg, kw, script):
    dog = PKGS[pkg]["guard"].DivergenceWatchdog(**kw)
    trace = [dog.healthy()]
    for step in script:
        if step[0] == "dispatch":
            dog.observe_dispatch(step[1], step[2])
        elif step[0] == "reward":
            dog.observe_reward(step[1])
        elif step[0] == "external":
            dog.trip_external(step[1])
        elif step[0] == "reset":
            dog.reset_after_rollback()
        else:
            trip = dog.poll(step[1])
            trace.append(None if trip is None else
                         (trip.signal, trip.dispatch_count,
                          None if math.isnan(trip.value) else trip.value,
                          trip.threshold))
        trace.append(dog.healthy())
    acct = dog.accounting()
    if acct["last_trip"] is not None and math.isnan(
            acct["last_trip"]["value"]):
        acct["last_trip"]["value"] = None
    return trace, acct


class TestWatchdog:
    @pytest.mark.parametrize("name", sorted(WATCHDOG_SCRIPTS))
    def test_trips_match_reference(self, name):
        kw, script = WATCHDOG_SCRIPTS[name]
        port = _run_watchdog("port", kw, script)
        assert port == _run_watchdog("jax", kw, script)
        trips = [t for t in port[0] if isinstance(t, tuple)]
        assert trips, f"{name}: the script never tripped"

    def test_resolves_lazy_metrics(self):
        """The port's probes ride LazyMetrics; the watchdog reads them
        like the JAX package's resolved device scalars."""
        import torch

        from relayrl_tpu_torch.runtime.pipeline import LazyMetrics

        dog = port_guard.DivergenceWatchdog(max_param_norm=10.0)
        dog.observe_dispatch(1, LazyMetrics({
            PROBE_NONFINITE: torch.tensor(0, dtype=torch.int32),
            PROBE_PARAM_NORM: torch.tensor(50.0),
            "LossPi": torch.tensor(0.5)}))
        trip = dog.poll(1)
        assert trip.signal == "param_norm" and trip.value == 50.0


def _algos(tmp_path, model_kind="mlp_discrete", **hp):
    """A port REINFORCE and its params carried into the flax layout."""
    from relayrl_tpu_torch.algorithms import build_algorithm

    hp = {"hidden_sizes": [16, 16], "with_vf_baseline": True,
          "traj_per_epoch": 2, "train_vf_iters": 2, "seed_salt": 0,
          "model_kind": model_kind, **hp}
    return build_algorithm(
        "REINFORCE", obs_dim=OBS_DIM, act_dim=ACT_DIM, device="cpu",
        env_dir=str(tmp_path),
        logger_kwargs={"output_dir": str(tmp_path / "logs")}, **hp)


TRANSFORMER = {"d_model": 16, "n_heads": 2, "n_layers": 1,
               "max_seq_len": 16, "bucket_lengths": [16]}


class TestGuardProbes:
    @pytest.mark.parametrize("model", ["mlp", "transformer"])
    def test_values_match_reference(self, model, tmp_path):
        import torch

        from relayrl_tpu_torch.weights import params_to_jax

        kind = "mlp_discrete" if model == "mlp" else "transformer_discrete"
        algo = _algos(tmp_path, model_kind=kind,
                      **(TRANSFORMER if model == "transformer" else {}))
        module = algo.state.params
        old_tree = params_to_jax(module)
        probes = port_guard.GuardProbes(update_norm=True)
        base = probes.pre_update(module)
        gen = torch.Generator().manual_seed(3)
        with torch.no_grad():
            for p in module.parameters():
                p.add_(0.01 * torch.randn(p.shape, generator=gen))
        new_tree = params_to_jax(module)
        got = {k: float(v) for k, v in
               probes.post_update(base, module).items()}
        ref = jax_guard.GuardProbes(update_norm=True)
        want = {k: float(v) for k, v in ref.post_update(
            ref.pre_update(old_tree), new_tree).items()}
        assert got.keys() == want.keys()
        assert got[PROBE_NONFINITE] == want[PROBE_NONFINITE] == 0
        for key in (PROBE_PARAM_NORM, PROBE_UPDATE_NORM):
            assert got[key] == pytest.approx(want[key],
                                             rel=PROBE_NORM_RTOL), key
            assert got[key] > 0

    def test_nonfinite_count_matches_reference(self, tmp_path):
        import torch

        from relayrl_tpu_torch.weights import params_to_jax

        module = _algos(tmp_path).state.params
        with torch.no_grad():
            first = next(module.parameters())
            first.view(-1)[:3] = torch.tensor(
                [float("nan"), float("inf"), -float("inf")])
        got = port_guard.GuardProbes(update_norm=False).post_update(
            None, module)
        want = jax_guard.GuardProbes(update_norm=False).post_update(
            None, params_to_jax(module))
        assert int(got[PROBE_NONFINITE]) == int(want[PROBE_NONFINITE]) == 3
        assert PROBE_UPDATE_NORM not in got
        assert math.isnan(float(got[PROBE_PARAM_NORM])) == math.isnan(
            float(want[PROBE_PARAM_NORM]))

    def test_reference_unit_values(self):
        probes = port_guard.GuardProbes(update_norm=True)
        copy = probes.pre_update({"w": np.array([3.0, 4.0], np.float32)})
        out = probes.post_update(copy,
                                 {"w": np.array([4.0, 5.0], np.float32)})
        assert int(out[PROBE_NONFINITE]) == 0
        assert float(out[PROBE_PARAM_NORM]) == pytest.approx(
            math.sqrt(41), rel=1e-6)
        assert float(out[PROBE_UPDATE_NORM]) == pytest.approx(
            math.sqrt(2), rel=1e-6)

    def test_integer_leaves_ignored(self):
        import torch

        probes = port_guard.GuardProbes(update_norm=False)
        assert probes.pre_update({"w": np.zeros(2, np.float32)}) is None
        for tree in ({"step": np.int32(7)}, {"step": torch.tensor(7)}):
            out = probes.post_update(None, tree)
            assert int(out[PROBE_NONFINITE]) == 0
            assert float(out[PROBE_PARAM_NORM]) == 0

    def test_probes_do_not_mutate_params(self, tmp_path):
        module = _algos(tmp_path).state.params
        before = {k: v.clone() for k, v in module.state_dict().items()}
        probes = port_guard.GuardProbes(update_norm=True)
        probes.post_update(probes.pre_update(module), module)
        for key, value in module.state_dict().items():
            assert value.equal(before[key]), key

    def test_fixed_operations_per_update(self):
        """A probe's non-view operations do not grow with the number of
        leaves: one ``cat`` gathers them (a kernel launch count that is
        fixed per update on the card)."""
        import torch
        from torch.utils._python_dispatch import TorchDispatchMode

        views = {"view", "_unsafe_view", "reshape", "alias", "detach",
                 "_to_copy", "lift_fresh"}

        class Count(TorchDispatchMode):
            def __init__(self):
                super().__init__()
                self.ops = []

            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                name = func.overloadpacket.__name__
                if name not in views:
                    self.ops.append(name)
                return func(*args, **(kwargs or {}))

        counts = []
        for n_leaves in (2, 40):
            module = torch.nn.ModuleList(
                [torch.nn.Linear(3, 3, bias=False) for _ in range(n_leaves)])
            probes = port_guard.GuardProbes(update_norm=True)
            with Count() as mode:
                probes.post_update(probes.pre_update(module), module)
            counts.append(mode.ops)
        assert counts[0] == counts[1]
        assert counts[0].count("cat") == 2

    def test_probe_failure_disables_once(self, tmp_path, capsys):
        algo = _algos(tmp_path)

        class Broken:
            def pre_update(self, tree):
                raise RuntimeError("probe exploded")

        algo._guard_probes = Broken()
        assert algo._guard_pre_update() is None
        assert algo._guard_probes is None
        assert algo._guard_merge_probes({"LossPi": 1.0}, None) == {
            "LossPi": 1.0}
        assert capsys.readouterr().out.count("probes DISABLED") == 1


# ---------------------------------------------------------------------------
# config plumbing: the port's loader gives the JAX loader's guardrails
# ---------------------------------------------------------------------------
class TestConfig:
    @pytest.mark.parametrize("cfg", [
        {},
        {"guardrails": {"strike_threshold": "bogus", "loss_window": -3,
                        "shed_policy": "weird", "ingest_validation": "nope",
                        "agent_share": 99, "max_steps": "x"}},
        {"guardrails": {"max_param_norm": None, "strike_window_s": None}},
        {"guardrails": {"max_steps": 0}},
        {"guardrails": {"max_steps": None}},
        {"guardrails": {"enabled": False}},
    ], ids=["defaults", "malformed", "null_thresholds", "zero_max_steps",
            "null_max_steps", "disabled"])
    def test_params_and_build_match_reference(self, cfg, tmp_path,
                                              monkeypatch):
        from relayrl_tpu.config.loader import ConfigLoader as JaxLoader
        from relayrl_tpu_torch.config import ConfigLoader as PortLoader

        monkeypatch.chdir(tmp_path)
        path = tmp_path / "cfg.json"
        path.write_text(json.dumps(cfg))
        jax_loader = JaxLoader("REINFORCE", str(path))
        port_loader = PortLoader("REINFORCE", str(path))
        assert port_loader.get_guardrails_params() == \
            jax_loader.get_guardrails_params()
        jax_g = jax_guard.build_guardrails(jax_loader)
        port_g = port_guard.build_guardrails(port_loader)
        assert (port_g is None) == (jax_g is None)
        if port_g is not None:
            assert port_g.params == jax_g.params
            assert port_g.accounting() == jax_g.accounting()
        assert port_guard.VALIDATION_MODES == jax_guard.VALIDATION_MODES

    def test_warn_mode_stands_the_finite_guard_down(self, tmp_path):
        for mode, want in (("warn", False), ("enforce", True)):
            algo = _algos(tmp_path)
            g = port_guard.Guardrails(_params("port", ingest_validation=mode))
            g.attach_algorithm(algo)
            assert algo.ingest_finite_guard is want
            assert isinstance(algo._guard_probes, port_guard.GuardProbes)
            algo.ingest_finite_guard = False
            assert algo.accumulate(_episode("port", rew=float("nan"))) \
                is None  # buffered, not dropped
            assert algo.dropped_nonfinite == 0


# ---------------------------------------------------------------------------
# checkpoint ring: healthy-at-save tags + last-known-good restore
# ---------------------------------------------------------------------------
def _ring(pkg, tmp_path, tags):
    """Save one checkpoint per tag (None = untagged) at versions 1..n;
    returns the healthy steps and the restored step (or the exception)."""
    if pkg == "jax":
        from relayrl_tpu.algorithms import build_algorithm
        from relayrl_tpu.checkpoint import (
            checkpoint_algorithm,
            restore_latest_healthy,
        )

        algo = build_algorithm(
            "REINFORCE", obs_dim=OBS_DIM, act_dim=ACT_DIM,
            env_dir=str(tmp_path), traj_per_epoch=1, hidden_sizes=[8],
            with_vf_baseline=False,
            logger_kwargs={"output_dir": str(tmp_path / "logs")})
    else:
        from relayrl_tpu_torch.checkpoint import (
            checkpoint_algorithm,
            restore_latest_healthy,
        )

        algo = _algos(tmp_path, hidden_sizes=[8], with_vf_baseline=False,
                      traj_per_epoch=1)
    ckdir = str(tmp_path / "ck")
    for version, tag in enumerate(tags, start=1):
        algo.force_version(version)
        checkpoint_algorithm(algo, ckdir, wait=True,
                             extra_meta=None if tag is None
                             else {"healthy": tag})
    healthy = algo._ckpt_mgr.healthy_steps()
    algo.force_version(9)
    try:
        step = restore_latest_healthy(algo, ckdir)
    except FileNotFoundError as e:
        step = type(e).__name__
    return healthy, step, int(algo.version)


class TestCheckpointRing:
    @pytest.mark.parametrize("tags", [
        [True, True, False], [False], [None], [True, None, False, True]],
        ids=["healthy_then_sick", "none_healthy", "untagged",
             "mixed"])
    def test_ring_matches_reference(self, tags, tmp_path):
        port = _ring("port", tmp_path / "port", tags)
        assert port == _ring("jax", tmp_path / "jax", tags)

    def test_restore_brings_params_and_adam_back(self, tmp_path):
        import torch

        from relayrl_tpu_torch.checkpoint import (
            checkpoint_algorithm,
            restore_latest_healthy,
        )
        from relayrl_tpu_torch.checkpoint.manager import (
            capture_state,
            train_state_digest,
        )

        algo = _algos(tmp_path)
        for i in range(4):
            algo.receive_trajectory(_episode("port", n=6, seed=i))
        checkpoint_algorithm(algo, str(tmp_path / "ck"),
                             extra_meta={"healthy": True})
        saved = train_state_digest(capture_state(algo.state))
        params_before = [p.data_ptr() for p in algo.state.params.parameters()]
        for i in range(4):
            algo.receive_trajectory(_episode("port", n=6, seed=10 + i))
        with torch.no_grad():
            next(algo.state.params.parameters()).fill_(float("nan"))
        assert restore_latest_healthy(algo, str(tmp_path / "ck")) == 2
        assert train_state_digest(capture_state(algo.state)) == saved
        # in place: the optimizers still hold the live parameters
        assert [p.data_ptr() for p in algo.state.params.parameters()] == \
            params_before
        opt_params = [p for g in algo.state.pi_opt.param_groups
                      for p in g["params"]]
        assert all(any(p is q for q in algo.state.params.parameters())
                   for p in opt_params)


# ---------------------------------------------------------------------------
# typed ingest nacks through the spool (both packages' spools)
# ---------------------------------------------------------------------------
class TestSpoolNacks:
    def test_quarantine_nack_discards_entry(self, pkg):
        mods = PKGS[pkg]
        calls = []

        def send_fn(payload, tagged):
            calls.append(tagged)
            raise mods["base"].IngestNack(mods["base"].NACK_QUARANTINED,
                                          "agent quarantined", 120.0)

        spool = mods["spool"].TrajectorySpool(send_fn=send_fn)
        spool.send(b"poison", "evil")
        assert spool.depth == 0 and len(calls) == 1
        assert spool.breaker.allow()

    def test_overload_nack_retains_for_replay(self, pkg):
        mods = PKGS[pkg]
        verdicts = [mods["base"].IngestNack(mods["base"].NACK_OVERLOADED,
                                            "overloaded", 0.5)]

        def send_fn(payload, tagged):
            if verdicts:
                raise verdicts.pop()

        spool = mods["spool"].TrajectorySpool(send_fn=send_fn)
        spool.send(b"traj", "a")
        assert spool.depth == 1 and spool.breaker.allow()
        assert spool.replay() == 1 and spool.depth == 1

    def test_overload_nack_replays_on_live_connection(self, pkg):
        mods = PKGS[pkg]
        delivered = []
        verdicts = [mods["base"].IngestNack(mods["base"].NACK_OVERLOADED,
                                            "overloaded", 0.0)]

        def send_fn(payload, tagged):
            if verdicts:
                raise verdicts.pop()
            delivered.append(tagged)

        spool = mods["spool"].TrajectorySpool(send_fn=send_fn)
        spool.send(b"first", "a")
        assert spool.depth == 1 and not delivered
        time.sleep(0.3)
        spool.send(b"second", "a")
        assert any(t.endswith("#s1") for t in delivered), delivered
        assert spool._replay_due is None

    def test_nack_codes_match_reference(self):
        for name in ("NACK_QUARANTINED", "NACK_OVERLOADED",
                     "NACK_UNAVAILABLE"):
            assert getattr(port_base, name) == getattr(jax_base, name)


# ---------------------------------------------------------------------------
# server integration over a stub transport
# ---------------------------------------------------------------------------
class StubTransport:
    def __init__(self):
        self.published = []
        self.on_trajectory = None
        self.on_trajectory_decoded = None
        self.get_model = None
        self.get_model_update = None
        self.get_model_version = None
        self.on_register = None
        self.on_unregister = None
        self.on_resync = None
        self.check_ingest = None

    def start(self):
        pass

    def stop(self):
        pass

    def publish_model(self, version, raw):
        self.published.append((int(version), len(raw)))


SERVER_HP = {"traj_per_epoch": 2, "hidden_sizes": [8],
             "with_vf_baseline": False, "seed_salt": 0}


def _write_config(tmp_path, guardrails=None, learner=None) -> str:
    cfg = {}
    if guardrails is not None:
        cfg["guardrails"] = guardrails
    if learner is not None:
        cfg["learner"] = learner
    path = tmp_path / "guard_config.json"
    path.write_text(json.dumps(cfg))
    return str(path)


@pytest.fixture
def port_server_factory(tmp_cwd, monkeypatch):
    """A port TrainingServer (CPU) over a stub transport."""
    import relayrl_tpu_torch.transport as port_transport
    from relayrl_tpu_torch.runtime.server import TrainingServer

    made = []

    def make(guardrails=None, learner=None, hp=None, start=True):
        stub = StubTransport()
        monkeypatch.setattr(port_transport, "make_server_transport",
                            lambda *a, **k: stub)
        server = TrainingServer(
            "REINFORCE", obs_dim=OBS_DIM, act_dim=ACT_DIM,
            env_dir=str(tmp_cwd),
            config_path=_write_config(tmp_cwd, guardrails, learner),
            hyperparams={**SERVER_HP, **(hp or {})}, start=start,
            device="cpu")
        made.append(server)
        return server, stub

    yield make
    for server in made:
        server.disable_server()


def _serialize(pkg, recs):
    return PKGS[pkg]["trajectory"].serialize_actions(recs)


def _wait(pred, what, timeout_s=60.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {what}")


def _settle(server):
    """Wait until every payload handed in has been staged (validated and
    struck) — the next ingest then sees the settled quarantine book."""
    _wait(lambda: server._ingest.unfinished_tasks == 0, "staging")


class TestServerIngestGuard:
    def test_poison_stream_rejected_struck_quarantined(
            self, port_server_factory):
        srv, _ = port_server_factory(
            guardrails={"strike_threshold": 2, "quarantine_cooldown_s": 300})
        srv.wait_warmup(60)
        poison = _serialize("port", _episode("port", rew=float("nan")))
        clean = _serialize("port", _episode("port", seed=7))
        for agent, payload in (("evil", poison), ("evil", poison),
                               ("good", clean), ("evil", clean)):
            srv._on_trajectory(agent, payload)
            _settle(srv)
        _wait(lambda: srv.stats["trajectories"] >= 1, "the clean episode")
        acct = srv.guardrails_accounting()
        assert acct["quarantine"]["quarantined"] == ["evil"]
        assert acct["quarantine"]["quarantines_total"] == 1
        assert srv.stats["trajectories"] == 1
        for p in srv.algorithm.state.params.parameters():
            assert p.isfinite().all()

    def test_check_ingest_verdicts(self, port_server_factory):
        srv, stub = port_server_factory(
            guardrails={"strike_threshold": 1, "shed_policy": "nack",
                        "ingest_soft_limit": 1,
                        "quarantine_cooldown_s": 300,
                        "nack_retry_after_s": 2.0}, start=False)
        assert stub.check_ingest == srv._check_ingest
        assert srv._check_ingest("anyone") is None
        srv.guardrails.quarantine.strike("evil", "nonfinite")
        code, _, retry = srv._check_ingest("evil")
        assert code == port_base.NACK_QUARANTINED and retry > 0
        code, _, _ = srv._check_ingest("evil#s7")
        assert code == port_base.NACK_QUARANTINED
        srv.guardrails.admission.note_enqueued("x")
        code, _, retry = srv._check_ingest("other")
        assert code == port_base.NACK_OVERLOADED and retry == 2.0

    def test_warn_mode_admits_but_strikes(self, port_server_factory):
        srv, _ = port_server_factory(
            guardrails={"ingest_validation": "warn", "strike_threshold": 100})
        srv.wait_warmup(60)
        assert srv.algorithm.ingest_finite_guard is False
        srv._on_trajectory("sloppy", _serialize(
            "port", _episode("port", rew=float("nan"))))
        _wait(lambda: srv.stats["trajectories"] >= 1, "the admitted item")
        acct = srv.guardrails_accounting()
        assert acct["quarantine"]["strikes_pending"].get("sloppy") == 1

    def test_disabled_guardrails_build_nothing(self, port_server_factory):
        srv, stub = port_server_factory(guardrails={"enabled": False},
                                        start=False)
        assert srv.guardrails is None and stub.check_ingest is None
        assert srv.guardrails_accounting() == {}
        assert srv.algorithm._guard_probes is None
        assert srv._health_tag() == {"healthy": True}

    def test_admission_drop_oldest_evicts_and_retracts(
            self, port_server_factory):
        srv, _ = port_server_factory(
            guardrails={"ingest_soft_limit": 2, "agent_share": 1.0},
            start=False)
        for seq in (1, 2, 3):
            srv._ingest_one(f"a#s{seq}", b"payload")
        assert srv._ingest.qsize() == 2
        assert [item[1] for item in list(srv._ingest.queue)] == [2, 3]
        acct = srv.guardrails_accounting()["admission"]
        assert acct["sheds"]["drop_oldest"] == 1 and acct["depth"] == 2
        # the evicted seq was retracted: its replay lands again
        srv._ingest.get_nowait()
        srv._ingest.task_done()
        srv.guardrails.admission.note_dequeued("a")
        srv._ingest_one("a#s1", b"payload")
        assert [item[1] for item in list(srv._ingest.queue)] == [3, 1]


class TestPublishGate:
    def test_nonfinite_params_never_publish(self, port_server_factory):
        srv, stub = port_server_factory(start=False)
        srv._publish_params(99, {"obs_dim": OBS_DIM},
                            {"w": np.array([1.0, float("nan")], np.float32)})
        assert stub.published == []
        assert srv.published_digest() is None
        assert not srv.guardrails.watchdog.healthy()
        assert srv.guardrails.watchdog.poll(0).signal == "publish_nonfinite"

    def test_finite_params_publish_normally(self, port_server_factory):
        from relayrl_tpu_torch.weights import params_to_jax

        srv, stub = port_server_factory(start=False)
        srv._publish_params(1, dict(srv.algorithm.arch),
                            params_to_jax(srv.algorithm.state.params))
        assert stub.published and stub.published[-1][0] == 1
        assert srv.guardrails.watchdog.healthy()


class TestRollback:
    def test_trip_rolls_back_to_healthy_and_resumes(
            self, port_server_factory):
        from relayrl_tpu_torch.checkpoint.manager import (
            CheckpointManager,
            capture_state,
            train_state_digest,
        )

        srv, stub = port_server_factory(
            learner={"checkpoint_every_epochs": 1},
            guardrails={"checkpoint_ring": 5})
        srv.wait_warmup(60)
        for i in range(4):
            srv._decoded.put(_episode("port", seed=i, n=6))
        assert srv.drain(timeout=60)
        assert srv.algorithm.version == 2
        saved = train_state_digest(capture_state(srv.algorithm.state))
        mgr = CheckpointManager(srv._checkpoint_dir)
        assert mgr.healthy_steps()[-1] == 2
        pre_version = srv.latest_model_version
        srv.guardrails.watchdog.trip_external("publish_nonfinite")
        for i in range(2):
            srv._decoded.put(_episode("port", seed=10 + i, n=6))
        _wait(lambda: srv.guardrails_accounting()["rollbacks_total"] >= 1,
              "the rollback")
        assert srv.drain(timeout=60)
        acct = srv.guardrails_accounting()
        assert acct["rollbacks_total"] == 1 and acct["halted"] is False
        assert train_state_digest(
            capture_state(srv.algorithm.state)) == saved
        assert srv.algorithm.version > pre_version
        assert stub.published[-1][0] == srv.algorithm.version
        assert srv.last_publish["kind"] in ("keyframe", "v1_passthrough")

    def test_rollback_budget_degrades_to_halt(self, port_server_factory):
        from relayrl_tpu_torch.guardrails.watchdog import Trip

        srv, _ = port_server_factory(guardrails={"max_rollbacks": 0},
                                     start=False)
        assert not srv.guardrails_halted
        srv._execute_rollback(Trip("nonfinite_params", 1.0, 0.0))
        assert srv.guardrails_halted
        acct = srv.guardrails_accounting()
        assert acct["halted"] is True and acct["rollbacks_total"] == 0
        before = srv._ingest.qsize()
        srv._ingest_one("a", b"payload")
        assert srv._ingest.qsize() == before
        code, reason, _ = srv._check_ingest("a")
        assert code == port_base.NACK_OVERLOADED and "halted" in reason
        assert srv._health_tag() == {"healthy": False}

    def test_no_healthy_checkpoint_halts(self, port_server_factory):
        from relayrl_tpu_torch.guardrails.watchdog import Trip

        srv, _ = port_server_factory(start=False)
        srv._execute_rollback(Trip("param_norm", 1e9, 1e6))
        assert srv.guardrails_halted

    def test_checkpoints_carry_health_tag(self, port_server_factory):
        from relayrl_tpu_torch.checkpoint.manager import CheckpointManager

        srv, _ = port_server_factory(learner={"checkpoint_every_epochs": 1})
        srv.wait_warmup(60)
        for i in range(2):
            srv._decoded.put(_episode("port", seed=i, n=6))
        assert srv.drain(timeout=60)
        mgr = CheckpointManager(srv._checkpoint_dir)
        steps = mgr.healthy_steps()
        assert steps and mgr.read_extra(steps[-1])["healthy"] is True

    def test_nonfinite_update_trips_the_probe_and_rolls_back(
            self, port_server_factory):
        """A finite but huge reward passes validation, drives the params
        non-finite, and the device probe (not the publish gate alone)
        trips the rollback; no non-finite params are published."""
        from relayrl_tpu_torch.weights import params_to_jax, tree_digest

        srv, stub = port_server_factory(
            learner={"checkpoint_every_epochs": 1},
            hp={"with_vf_baseline": True, "train_vf_iters": 2})
        srv.wait_warmup(60)
        for i in range(2):
            srv._decoded.put(_episode("port", seed=i, n=6))
        assert srv.drain(timeout=60)
        healthy = tree_digest(params_to_jax(srv.algorithm.state.params))
        for i in range(2):
            recs = _episode("port", seed=20 + i, n=6)
            for rec in recs:
                rec.rew = 1e38
            srv._on_trajectory(f"loud#s{i + 1}", _serialize("port", recs))
        _wait(lambda: srv.guardrails_accounting()["rollbacks_total"] >= 1,
              "the rollback")
        assert srv.drain(timeout=60)
        acct = srv.guardrails_accounting()
        assert acct["watchdog"]["last_trip"]["signal"] in (
            "nonfinite_params", "publish_nonfinite")
        assert acct["rollbacks_total"] == 1 and not acct["halted"]
        assert tree_digest(params_to_jax(srv.algorithm.state.params)) == \
            healthy
        assert srv.published_digest() == (srv.algorithm.version, healthy)
        assert srv.stats["learner_errors"] == 0


# ---------------------------------------------------------------------------
# one stream through a JAX server and a port server
# ---------------------------------------------------------------------------
def _stream(pkg):
    """(agent, payload) pairs: clean, NaN, wrong shape (columnar frame),
    over-length, in an order that quarantines two agents."""
    mods = PKGS[pkg]
    ser = mods["trajectory"].serialize_actions
    wrong = _decoded(pkg, n=3, agent="")
    wrong.columns["r"] = np.zeros((2,), np.float32)
    wrong_frame = mods["columnar"].encode_columnar_frame(wrong)
    out = []
    for i in range(4):
        out.append((f"good#s{i + 1}", ser(_episode(pkg, n=6, seed=i))))
    for i in range(3):
        out.append((f"nan#s{i + 1}",
                    ser(_episode(pkg, n=6, seed=10 + i,
                                 rew=float("nan")))))
    out.append((f"shape#s1", wrong_frame))
    out.append((f"shape#s2", wrong_frame))
    out.append((f"long#s1", ser(_episode(pkg, n=12, seed=30))))
    out.append((f"nan#s4", ser(_episode(pkg, n=6, seed=14))))
    out.append((f"shape#s3", wrong_frame))
    out.append((f"good#s5", ser(_episode(pkg, n=6, seed=5))))
    out.append((f"good#s6", ser(_episode(pkg, n=6, seed=6))))
    return out


def _guard_counters(tel) -> dict:
    snap = tel.get_registry().snapshot()
    out = {}
    for m in snap["metrics"]:
        if m["name"].startswith("relayrl_guard_") and m["value"]:
            labels = ",".join(f"{k}={v}" for k, v in
                              sorted(m["labels"].items()))
            out[f"{m['name']}{{{labels}}}"] = m["value"]
    return out


class TestServersAgreeOnOneStream:
    def test_same_verdicts_and_rollback_step(self, tmp_path, monkeypatch):
        import relayrl_tpu.checkpoint as jax_ckpt
        import relayrl_tpu.runtime.server as jax_srv_mod
        import relayrl_tpu_torch.checkpoint as port_ckpt
        import relayrl_tpu_torch.transport as port_transport
        from relayrl_tpu_torch.runtime.server import TrainingServer

        restored = {}

        def spy(pkg, fn):
            def wrapped(*a, **k):
                restored[pkg] = fn(*a, **k)
                return restored[pkg]
            return wrapped

        monkeypatch.setattr(jax_ckpt, "restore_latest_healthy",
                            spy("jax", jax_ckpt.restore_latest_healthy))
        monkeypatch.setattr(port_ckpt, "restore_latest_healthy",
                            spy("port", port_ckpt.restore_latest_healthy))
        servers, stubs = {}, {}
        try:
            for pkg in ("jax", "port"):
                work = tmp_path / pkg
                work.mkdir()
                monkeypatch.chdir(work)
                tel = PKGS[pkg]["telemetry"]
                tel.set_registry(tel.Registry(run_id=f"stream-{pkg}"))
                stubs[pkg] = StubTransport()
                mod = jax_srv_mod if pkg == "jax" else port_transport
                monkeypatch.setattr(mod, "make_server_transport",
                                    lambda *a, s=stubs[pkg], **k: s)
                config = _write_config(
                    work, guardrails={"strike_threshold": 2,
                                      "max_steps": 8,
                                      "quarantine_cooldown_s": 300},
                    learner={"checkpoint_every_epochs": 1})
                kw = {"device": "cpu"} if pkg == "port" else {}
                cls = (jax_srv_mod.TrainingServer if pkg == "jax"
                       else TrainingServer)
                servers[pkg] = cls(
                    "REINFORCE", obs_dim=OBS_DIM, act_dim=ACT_DIM,
                    env_dir=str(work), config_path=config,
                    hyperparams=dict(SERVER_HP), **kw)
                servers[pkg].wait_warmup(120)
            verdicts = {}
            for pkg, srv in servers.items():
                trace = []
                for agent, payload in _stream(pkg):
                    srv._on_trajectory(agent, payload)
                    _settle(srv)
                    trace.append((agent, srv.guardrails.quarantine
                                  .is_quarantined(agent.split("#")[0])))
                assert srv.drain(timeout=120)
                verdicts[pkg] = (trace, srv.guardrails_accounting(),
                                 _guard_counters(PKGS[pkg]["telemetry"]),
                                 srv.stats["trajectories"],
                                 srv.algorithm.version)
            assert verdicts["port"] == verdicts["jax"]
            trace, acct, counters, trajectories, version = verdicts["port"]
            assert acct["quarantine"]["quarantined"] == ["nan", "shape"]
            assert counters["relayrl_guard_rejected_total{reason=nonfinite}"] \
                == 2
            assert counters["relayrl_guard_rejected_total{reason=shape}"] == 2
            assert counters["relayrl_guard_rejected_total{reason=length}"] == 1
            assert counters["relayrl_guard_quarantine_rejects_total{}"] == 3
            assert (trajectories, version) == (6, 3)
            # Trip both (the idle learner polls it), then one more epoch:
            # each rolls back to its newest healthy step and trains on.
            for pkg, srv in servers.items():
                srv.guardrails.watchdog.trip_external("publish_nonfinite")
                _wait(lambda s=srv: s.guardrails_accounting()[
                    "rollbacks_total"] >= 1, f"the {pkg} rollback")
                for agent, payload in _stream(pkg)[:2]:
                    srv._on_trajectory(agent.replace("good", "late"), payload)
                assert srv.drain(timeout=120)
            assert restored["port"] == restored["jax"] == 3
            after = {pkg: (srv.guardrails_accounting()["rollbacks_total"],
                           srv.guardrails_accounting()["halted"],
                           srv.algorithm.version)
                     for pkg, srv in servers.items()}
            assert after["port"] == after["jax"] == (1, False, 5)
        finally:
            for srv in servers.values():
                srv.disable_server()


# ---------------------------------------------------------------------------
# probes are observers: bit-identical params on vs off
# ---------------------------------------------------------------------------
class TestBitIdentity:
    @pytest.mark.parametrize("model", ["mlp", "transformer"])
    def test_probes_do_not_perturb_training(self, model, tmp_path):
        kind = "mlp_discrete" if model == "mlp" else "transformer_discrete"
        extra = TRANSFORMER if model == "transformer" else {}

        def run(with_probes):
            algo = _algos(tmp_path / f"run{with_probes}", model_kind=kind,
                          **extra)
            if with_probes:
                algo._guard_probes = port_guard.GuardProbes(update_norm=True)
            for i in range(6):
                algo.receive_trajectory(_episode("port", n=8, seed=100 + i))
            assert algo.version == 3
            if with_probes:
                metrics = algo._last_metrics
                assert metrics[PROBE_NONFINITE] == 0
                assert metrics[PROBE_PARAM_NORM] > 0
                assert metrics[PROBE_UPDATE_NORM] > 0
                assert algo._guard_probes is not None
            return {k: v.clone() for k, v in
                    algo.state.params.state_dict().items()}

        off, on = run(False), run(True)
        assert off.keys() == on.keys()
        for key in off:
            assert off[key].equal(on[key]), key
