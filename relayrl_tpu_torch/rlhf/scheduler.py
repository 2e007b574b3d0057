"""The RLHF dataflow scheduler: generate → score → update as decoupled
stages over the actor tiers.

Counterpart of :mod:`relayrl_tpu.rlhf.scheduler`. Stage map — every stage
rides machinery the port already has:

* **generate** — a :class:`GenerationStage` steps ``rlhf.lanes`` TokenGen
  lanes through ONE batched policy dispatch per round. Sequence
  (transformer) policies run the vector tier's ``step_window`` path
  (``runtime/vector_actor.py``; a batch-of-1 stage is bit-identical to a
  ``PolicyActor`` serving through its window at the same seed and params,
  which ``tests/test_torch_rlhf.py`` holds). ``rlhf.generation_tier:
  "anakin"`` moves generation into the fused window
  (:class:`FusedGenerationStage`: the device TokenGen inside the window, a
  CUDA graph on the card, ``lanes × unroll`` tokens per dispatch);
  ``"remote"`` generates through thin clients against the serving plane
  (:class:`_RemoteLanes`; keep ``serving.max_sessions`` at or above the
  lane count). Behavior evidence is recorded per token: ``logp_a`` rides
  every record's aux, and the stage adds ``bver``, the params version the
  token was sampled under.
* **score** — completed generations are withheld from the wire (the
  ``VectorAgent.send_interceptor`` seam) and handed to a
  :class:`ScoreStage` thread, which batches them into one scorer dispatch,
  writes the terminal reward into the episode's marker record (or the
  folded ``r[-1]`` of a columnar frame), and re-injects via
  ``VectorAgent.emit_lane``. Sequence numbers are assigned at emission, so
  the spool's at-least-once window only ever holds scored bytes.
* **update** — the unmodified training server: scored episodes flow
  through spool/seq-dedup/columnar ingest into the IMPALA learner, whose
  V-trace correction (``ops/vtrace.py``) importance-weights each token
  from its recorded behavior log-prob. ``learner.freeze`` masks
  (``algorithms/freeze.py``) make the fine-tune recipe first-class.

Telemetry, on the port's registry: ``relayrl_rlhf_generated_tokens_total``,
``relayrl_rlhf_scored_episodes_total``,
``relayrl_rlhf_stage_seconds{stage=generate|score|emit}`` and
``relayrl_rlhf_lag_versions`` (behavior vs actor-held version at
emission); the server adds ``relayrl_rlhf_train_lag_versions``. With
tracing on (``telemetry/trace.py``), each generation round that completes
episodes records a ``generate`` span and each score batch a ``score`` and
an ``emit`` span (kind ``rlhf``, with the episode count); an episode the
score stage withheld from a VectorAgent keeps the emission stamps it was
produced with, so its trajectory trace starts at its generation.

Every entry point runs on the GPU unless the caller passes
``device="cpu"``: the scheduler's policy host and its reward model both
take ``device``.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Callable

import numpy as np

from relayrl_tpu_torch.types.columnar import (
    DecodedTrajectory,
    encode_columnar_frame,
    is_columnar_frame,
    parse_frame,
)
from relayrl_tpu_torch.types.trajectory import (
    deserialize_actions,
    serialize_actions,
)

#: Version-lag buckets: unit-ish resolution near on-policy, coarse tail.
LAG_BUCKETS = (0.0, 1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0)

_STAGE_SECONDS = ("relayrl_rlhf_stage_seconds",
                  "wall seconds per stage dispatch on the RLHF dataflow")
_GENERATED = ("relayrl_rlhf_generated_tokens_total",
              "tokens generated (one per lane per batched dispatch)")


def _check_context(tokens: np.ndarray, prompt_len: int, gen_len: int) -> int:
    write = int(prompt_len) + gen_len - 1
    if write >= tokens.shape[0]:
        raise ValueError(
            f"generation of {gen_len} tokens overflows the context window "
            f"({tokens.shape[0]} with prompt_len {prompt_len})")
    return write


def extract_generation(records, prompt_len: int):
    """Serialized-episode records → ``(tokens[i32], gen_len, marker)``.

    ``records`` is one episode as shipped by an actor tier: real steps
    (obs = the pre-action token context window, act = the token) plus the
    trailing terminal marker from ``flag_last_action``. The full generated
    sequence is the LAST real step's context with its action written at the
    final write position. Token values are small integers, exact in the
    float32 the wire normalizes observations to."""
    real = [r for r in records if r.act is not None]
    if not real:
        raise ValueError("episode has no real steps to score")
    marker = records[-1] if records[-1].act is None else None
    gen_len = len(real)
    last = real[-1]
    tokens = np.asarray(last.obs).astype(np.int32).reshape(-1).copy()
    tokens[_check_context(tokens, prompt_len, gen_len)] = int(
        np.asarray(last.act).reshape(-1)[0])
    return tokens, gen_len, marker


def extract_generation_frame(dt: DecodedTrajectory, prompt_len: int):
    """Columnar twin of :func:`extract_generation`: one decoded frame (the
    anakin tier ships whole episodes as columnar frames, markers folded) →
    ``(tokens[i32], gen_len)``. The score lands on ``r[-1]``, where the
    server's decoder folds a scored marker's reward, so the frame must be
    one terminated episode (``n_records == n_steps + 1``)."""
    if dt.n_steps < 1:
        raise ValueError("frame has no real steps to score")
    if dt.n_records != dt.n_steps + 1:
        raise ValueError(
            f"frame is not one terminated episode (n_steps {dt.n_steps}, "
            f"n_records {dt.n_records}) — the score stage patches the "
            f"folded terminal reward, which a mid-episode chunk lacks")
    gen_len = int(dt.n_steps)
    tokens = np.asarray(dt.columns["o"][-1]).astype(np.int32).reshape(-1).copy()
    tokens[_check_context(tokens, prompt_len, gen_len)] = int(
        np.asarray(dt.columns["a"][-1]).reshape(-1)[0])
    return tokens, gen_len


class ScoreStage:
    """Decoupled scoring: batches completed generations into one scorer
    dispatch, assigns the terminal reward, re-emits.

    ``submit`` runs on the generation thread and blocks while ``max_queue``
    episodes are parked (backpressure: a slow scorer throttles generation).
    The worker gathers up to ``batch`` episodes, waiting ``linger_s`` after
    the first for siblings, scores them in ONE ``score_batch_np`` dispatch
    (a short batch is padded with repeats of row 0 and sliced), patches each
    episode's terminal reward, and hands the re-serialized bytes to
    ``emit_fn(lane, payload)`` (``emit_fn(lane, payload, stamps)`` when
    the episode was submitted with its emission stamps). ``version_fn``
    (the actor-held version) feeds the emission lag histogram.
    """

    def __init__(self, scorer, prompt_len: int, emit_fn: Callable,
                 batch: int = 8, linger_s: float = 0.02,
                 max_queue: int = 256, version_fn: Callable | None = None):
        from relayrl_tpu_torch import telemetry

        self.scorer = scorer
        self.prompt_len = int(prompt_len)
        self.emit_fn = emit_fn
        self.batch = max(1, int(batch))
        self.linger_s = max(0.0, float(linger_s))
        self.version_fn = version_fn
        self._q: queue.Queue = queue.Queue(maxsize=max(1, int(max_queue)))
        self._stop = threading.Event()
        self._error: BaseException | None = None
        self.scored: list[float] = []  # per-episode scores, arrival order
        self._scored_lock = threading.Lock()
        reg = telemetry.get_registry()
        self._m_scored = reg.counter(
            "relayrl_rlhf_scored_episodes_total",
            "completed generations scored and re-emitted")
        self._m_score_s = reg.histogram(*_STAGE_SECONDS, labels={"stage": "score"})
        self._m_emit_s = reg.histogram(*_STAGE_SECONDS, labels={"stage": "emit"})
        self._m_lag = reg.histogram(
            "relayrl_rlhf_lag_versions",
            "behavior version vs actor-held version at emission "
            "(tokens sampled N publishes behind the model they train)",
            buckets=LAG_BUCKETS)
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="rlhf-score")
        self._thread.start()

    def submit(self, lane: int, payload: bytes, stamps=None) -> None:
        # A bounded put in a re-checking loop, not one blocking put: if the
        # worker dies while the queue is full, nothing drains it, and one
        # q.put() would block the generation thread forever (inside the
        # host lock, wedging model swaps too) instead of raising.
        while True:
            if self._error is not None:
                raise RuntimeError("score stage died") from self._error
            if self._stop.is_set():
                raise RuntimeError("score stage is closed")
            try:
                self._q.put((lane, payload, stamps), timeout=0.5)
                return
            except queue.Full:
                continue

    def _gather(self):
        """One batch: block for the first episode, then linger for siblings
        up to ``batch``."""
        try:
            first = self._q.get(timeout=0.1)
        except queue.Empty:
            return []
        out = [first]
        deadline = time.monotonic() + self.linger_s
        while len(out) < self.batch:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                out.append(self._q.get(timeout=remaining))
            except queue.Empty:
                break
        return out

    def _score_batch(self, episodes):
        """(lane, records, tokens, gen_len, marker) rows → scores [n]."""
        n = len(episodes)
        batched = getattr(self.scorer, "score_batch_np", None)
        if batched is None:
            return [float(self.scorer.score_np(tok, self.prompt_len, gl))
                    for (_l, _r, tok, gl, _m) in episodes]
        width = self.batch if n <= self.batch else n
        tokens = np.stack([episodes[i % n][2] for i in range(width)])  # pad: repeat rows
        gen_lens = np.asarray([episodes[i % n][3] for i in range(width)], np.int32)
        scores = batched(tokens, self.prompt_len, gen_lens)
        return [float(s) for s in scores[:n]]

    def _observe_lag(self, held: int, bvers) -> None:
        for bver in bvers:
            self._m_lag.observe(max(0, held - int(bver)))

    def _patch(self, records, marker, score: float, held) -> bytes:
        """The episode's bytes with its terminal reward set to ``score``."""
        if isinstance(records, DecodedTrajectory):
            # The marker is folded, so the score IS the terminal row's
            # reward (the terminal record's own rew is masked to 0 and
            # update_reward replaces it). ``u`` stays untouched: u[-1] = 0
            # mirrors the per-record fold exactly.
            r_col = np.array(records.columns["r"], copy=True)
            r_col[-1] = r_col.dtype.type(score)
            records.columns = dict(records.columns)
            records.columns["r"] = r_col
            bvers = records.aux.get("bver")
            if held is not None and bvers is not None:
                self._observe_lag(held, np.asarray(bvers).reshape(-1).tolist())
            return encode_columnar_frame(records)
        if marker is not None:
            marker.update_reward(float(score))
        else:  # defensive: an episode that ended without a marker
            records[-1].update_reward(records[-1].rew + float(score))
        if held is not None:
            self._observe_lag(held, [r.data["bver"] for r in records
                                     if "bver" in (r.data or {})])
        return serialize_actions(records)

    def _loop(self) -> None:
        try:
            while not (self._stop.is_set() and self._q.empty()):
                batch = self._gather()
                if not batch:
                    continue
                from relayrl_tpu_torch.telemetry import trace as trace_mod

                tracer = trace_mod.get_tracer()
                trace_id = tracer.sample_id("rlhf")
                t0_ns = time.monotonic_ns() if trace_id else 0
                t0 = time.monotonic()
                episodes = []
                for lane, payload, _stamps in batch:
                    if is_columnar_frame(payload):
                        # Anakin-tier generation: one whole episode per
                        # frame; the decoded frame stands in for the record
                        # list and there is no marker object.
                        dt = parse_frame(payload)
                        tokens, gen_len = extract_generation_frame(dt, self.prompt_len)
                        episodes.append((lane, dt, tokens, gen_len, None))
                    else:
                        records = deserialize_actions(payload)
                        tokens, gen_len, marker = extract_generation(
                            records, self.prompt_len)
                        episodes.append((lane, records, tokens, gen_len, marker))
                scores = self._score_batch(episodes)
                self._m_score_s.observe(time.monotonic() - t0)
                if trace_id:
                    t1_ns = time.monotonic_ns()
                    tracer.span("rlhf", trace_id, "score", t0_ns, t1_ns,
                                episodes=len(episodes))
                t1 = time.monotonic()
                held = int(self.version_fn()) if self.version_fn is not None else None
                for (lane, records, _tok, _gl, marker), score, (_l, _p, stamps) in zip(
                        episodes, scores, batch):
                    out = self._patch(records, marker, score, held)
                    if stamps is None:
                        self.emit_fn(lane, out)
                    else:
                        self.emit_fn(lane, out, stamps)
                    self._m_scored.inc()
                    with self._scored_lock:
                        self.scored.append(float(score))
                self._m_emit_s.observe(time.monotonic() - t1)
                if trace_id:
                    tracer.span("rlhf", trace_id, "emit", t1_ns,
                                time.monotonic_ns(), episodes=len(episodes))
        except BaseException as e:  # surfaced on the next submit/close
            self._error = e
            print(f"[rlhf] score stage died: {e!r}", flush=True)

    def scored_snapshot(self) -> list[float]:
        with self._scored_lock:
            return list(self.scored)

    def close(self, timeout_s: float = 30.0) -> None:
        """Drain-and-stop: everything submitted before close() is scored and
        emitted (the flush contract a final spool replay relies on)."""
        self._stop.set()
        self._thread.join(timeout=timeout_s)
        if self._error is not None:
            raise RuntimeError("score stage died") from self._error


def _generate_span(gen_dt: float, lanes: int, episodes: int) -> None:
    """The ``generate`` span of one round that closed ``episodes``
    generations. Drawn at episode granularity only: a per-token draw would
    churn the sampling lock and, at rate 1.0, flood the flight recorder
    with one span per token across all lanes."""
    from relayrl_tpu_torch.telemetry import trace as trace_mod

    tracer = trace_mod.get_tracer()
    if tracer.enabled:
        trace_id = tracer.sample_id("rlhf")
        if trace_id:
            now_ns = time.monotonic_ns()
            tracer.span("rlhf", trace_id, "generate",
                        now_ns - int(gen_dt * 1e9), now_ns,
                        lanes=lanes, episodes=episodes)


class GenerationStage:
    """The generate stage: one batched policy dispatch per round across
    ``lanes`` TokenGen lanes (scorer=None — rewards are the score stage's
    job), stamping each record with the behavior version ``bver``. Drives
    anything with the batched actor-host surface (``request_for_actions``,
    per-lane ``flag_last_action``, ``version``): a
    :class:`~relayrl_tpu_torch.runtime.vector_actor.VectorActorHost`, a
    live :class:`~relayrl_tpu_torch.runtime.agent.VectorAgent`'s host, or
    the scheduler's remote-lane adapter."""

    def __init__(self, host, venv, seed: int | None = None):
        from relayrl_tpu_torch import telemetry

        self.host = host
        self.venv = venv
        self.obs, _ = venv.reset(seed=seed)
        self.episodes_started = venv.num_envs
        self.episodes_done = 0
        self.tokens_generated = 0
        self.rounds = 0
        reg = telemetry.get_registry()
        self._m_tokens = reg.counter(*_GENERATED)
        self._m_gen_s = reg.histogram(*_STAGE_SECONDS, labels={"stage": "generate"})

    def run_round(self) -> int:
        """One token per lane: dispatch, stamp ``bver``, step the envs, flag
        finished lanes (terminal reward 0.0 — the score stage owns it).
        Returns the number of episodes that completed."""
        from relayrl_tpu_torch.runtime.agent import coerce_env_action

        t0 = time.monotonic()
        records = self.host.request_for_actions(self.obs)
        bver = np.int32(self.host.version)
        for r in records:
            # The version the batch's single params read served, stamped
            # before the episode's flush.
            r.data["bver"] = bver
        actions = [coerce_env_action(r.act) for r in records]
        self.obs, _rews, terms, truncs, _infos = self.venv.step(actions)
        done = 0
        for lane in range(self.venv.num_envs):
            if terms[lane] or truncs[lane]:
                self.host.flag_last_action(lane, 0.0, terminated=True)
                done += 1
        self._m_tokens.inc(self.venv.num_envs)
        gen_dt = time.monotonic() - t0
        self._m_gen_s.observe(gen_dt)
        if done:
            _generate_span(gen_dt, self.venv.num_envs, done)
        self.rounds += 1
        self.tokens_generated += self.venv.num_envs
        self.episodes_done += done
        self.episodes_started += done  # autoreset: a new one began
        return done


class FusedGenerationStage:
    """Anakin-tier generate stage (``rlhf.generation_tier: "anakin"``):
    generation runs inside the fused window — the device TokenGen steps
    with the rolling-window carry, so one ``rollout()`` produces ``lanes ×
    unroll_length`` tokens with no per-token host round trip. ``bver`` is
    stamped at unstack (``record_bver=True``: a window is one model version)
    and ``logp_a`` rides each record's aux, so the behavior evidence equals
    the vector tier's. Episodes still leave through the interceptor seam;
    this object drives rollouts and keeps the pacing loop's accounting
    surface (``host``, ``episodes_done``, ``run_round``,
    ``tokens_generated``)."""

    def __init__(self, agent):
        from relayrl_tpu_torch import telemetry

        self.agent = agent
        self.host = agent.host
        self.episodes_done = 0
        self.tokens_generated = 0
        self.rounds = 0
        reg = telemetry.get_registry()
        self._m_tokens = reg.counter(*_GENERATED)
        self._m_gen_s = reg.histogram(*_STAGE_SECONDS, labels={"stage": "generate"})

    def run_round(self) -> int:
        """One fused window. Returns completed episodes (TokenGen ends every
        episode as ``terminated``, so the window's autoreset starts the next
        prompt on the device)."""
        t0 = time.monotonic()
        stats = self.agent.rollout()
        self._m_tokens.inc(int(stats["steps"]))
        gen_dt = time.monotonic() - t0
        self._m_gen_s.observe(gen_dt)
        self.rounds += 1
        self.tokens_generated += int(stats["steps"])
        done = int(stats["episodes"])
        if done:
            _generate_span(gen_dt, self.agent.num_envs, done)
        self.episodes_done += done
        return done


class _RemoteLanes:
    """Thin-client generation tier: N ``RemoteActorClient`` lanes against
    the serving plane, adapted to the batched actor-host surface the
    GenerationStage drives. Sequence policies serve through the service's
    per-session window table — keep ``serving.max_sessions`` at or above
    the lane count.

    The N round trips fire concurrently (one worker per lane): serial
    requests would cost N x the round trip per token and show the service's
    size-or-linger batcher batches of one. Each client has its own lock."""

    def __init__(self, clients):
        import concurrent.futures

        self.clients = clients
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=len(clients), thread_name_prefix="rlhf-remote")

    @property
    def version(self) -> int:
        return max(c.version for c in self.clients)

    def request_for_actions(self, obs, masks=None, rewards=None):
        futures = [self._pool.submit(c.request_for_action, obs[i])
                   for i, c in enumerate(self.clients)]
        return [f.result() for f in futures]

    def close(self) -> None:
        self._pool.shutdown(wait=True)

    def flag_last_action(self, lane: int, reward: float = 0.0,
                         truncated: bool = False, final_obs=None,
                         terminated: bool | None = None, final_mask=None):
        self.clients[lane].flag_last_action(
            reward, truncated=truncated, final_obs=final_obs,
            terminated=terminated, final_mask=final_mask)


class RlhfScheduler:
    """Wires the three stages against a live training server.

    ``server_type``/``addr_overrides`` point at the server exactly like an
    Agent's; the learner side (algorithm, ``learner.freeze``, V-trace
    knobs) is the server's config — this object is purely the actor-plane
    orchestrator. ``scorer`` overrides the config-resolved one (any object
    with ``score_np``/``score_batch_np``). ``device`` places the policy
    host and the reward model (default: the GPU; without one pass
    ``"cpu"``). ``seed`` seeds the hosts' ``torch.Generator``s and is what
    makes a run repeatable; the JAX scheduler's ``rng_keys`` (threefry
    keys per lane) have no meaning here and are refused.
    """

    def __init__(
        self,
        config_path: str | None = None,
        server_type: str = "zmq",
        seed: int = 0,
        identity: str | None = None,
        lanes: int | None = None,
        scorer=None,
        generation_tier: str | None = None,
        rng_keys=None,
        handshake_timeout_s: float = 60.0,
        device=None,
        **addr_overrides,
    ):
        if rng_keys is not None:
            raise ValueError(
                "rng_keys: the port's hosts draw from a torch.Generator seeded "
                "with `seed` and take no threefry keys; pass seed instead")
        from relayrl_tpu_torch.config import ConfigLoader
        from relayrl_tpu_torch.envs import SyncVectorEnv, TokenGenEnv
        from relayrl_tpu_torch.models.base import resolve_device

        self.config = ConfigLoader(None, config_path)
        p = self.config.get_rlhf_params()
        self.params = p
        self.device = resolve_device(device)
        self.lanes = int(lanes if lanes is not None else p["lanes"])
        self.tier = str(generation_tier or p["generation_tier"])
        self.prompt_len = p["prompt_len"]
        # The reward model is built and warmed before any host exists: on
        # the anakin tier the host captures its window in the constructor,
        # and the score thread must not be the first to touch the card.
        self.scorer = scorer if scorer is not None else self._make_scorer(p)

        # Env lanes run scorer-less: the terminal reward is the score
        # stage's to assign. The anakin tier has no host-side envs at all.
        if self.tier == "anakin":
            self.venv = None
        else:
            def env_fn():
                return TokenGenEnv(vocab_size=p["vocab_size"],
                                   prompt_len=p["prompt_len"],
                                   max_new_tokens=p["max_new_tokens"],
                                   scorer=None)

            self.venv = SyncVectorEnv([env_fn for _ in range(self.lanes)])

        if self.tier == "remote":
            from relayrl_tpu_torch.runtime.inference import RemoteActorClient

            base = identity or f"rlhf-{seed}"
            clients = [RemoteActorClient(
                config_path=config_path, server_type=server_type,
                seed=seed + k, identity=f"{base}.lane{k}",
                handshake_timeout_s=handshake_timeout_s, **addr_overrides)
                for k in range(self.lanes)]
            self.agent = None
            self._clients = clients
            host = _RemoteLanes(clients)
            # Interpose the score stage on each lane's episode flow (the
            # VectorAgent seam, client-shaped): the original sender becomes
            # the stage's emit target.
            sends = [c.trajectory._on_send for c in clients]
            for k, c in enumerate(clients):
                c.trajectory._on_send = (
                    lambda payload, _k=k: self._withhold(_k, payload))
            self._emit = lambda lane, payload: sends[lane](payload)
            version_fn = lambda: host.version  # noqa: E731
        else:
            from relayrl_tpu_torch.runtime.agent import VectorAgent

            # Fused generation: the device TokenGen in the window, whole
            # episodes shipped as columnar frames, bver stamped at unstack;
            # withheld episodes come back through emit_lane.
            tier_kwargs = (dict(host_mode="anakin", unroll_length=p["generation_unroll"],
                                jax_env="TokenGen-v0",
                                jax_env_kwargs={"vocab_size": p["vocab_size"],
                                                "prompt_len": p["prompt_len"],
                                                "max_new_tokens": p["max_new_tokens"]},
                                record_bver=True)
                           if self.tier == "anakin" else dict(host_mode="vector"))
            self.agent = VectorAgent(
                num_envs=self.lanes, server_type=server_type, seed=seed,
                identity=identity, handshake_timeout_s=handshake_timeout_s,
                send_interceptor=self._withhold, config_path=config_path,
                device=self.device, **tier_kwargs, **addr_overrides)
            self._clients = []
            host = self.agent.host
            self._emit = (lambda lane, payload, stamps=None:
                          self.agent.emit_lane(lane, payload, _stamps=stamps))
            version_fn = lambda: self.agent.host.version  # noqa: E731

        self.score_stage = ScoreStage(
            self.scorer, prompt_len=p["prompt_len"], emit_fn=self._emit,
            batch=p["score_batch"], max_queue=p["score_queue"],
            version_fn=version_fn)
        self.generation = (FusedGenerationStage(self.agent)
                           if self.tier == "anakin"
                           else GenerationStage(host, self.venv, seed=seed))

    def _make_scorer(self, p: dict):
        from relayrl_tpu_torch.rlhf.scorers import make_scorer

        if p["scorer"] == "reward_model":
            context = p["prompt_len"] + p["max_new_tokens"]
            rm = make_scorer(
                "reward_model", vocab_size=p["vocab_size"], context_len=context,
                d_model=p["rm_d_model"], n_layers=p["rm_n_layers"],
                seed=p["rm_seed"], device=self.device,
                batch_rows=p["score_batch"])
            rm.score_batch_np(np.ones((1, context), np.int32), p["prompt_len"], [1])
            return rm
        return make_scorer("programmatic", vocab_size=p["vocab_size"])

    def _withhold(self, lane: int, payload: bytes):
        # A VectorAgent's emission stamps describe this payload only now
        # (inside its flush): they ride with the episode to its emission.
        stamps = (self.agent._emit_stamps(lane) if self.agent is not None
                  else None)
        self.score_stage.submit(lane, payload, stamps)
        return None  # the stage re-injects via emit after scoring

    # -- driving --
    def run(self, episodes: int, deadline_s: float = 300.0) -> dict:
        """Generate until ``episodes`` generations have been scored and
        emitted (or the deadline passes), pacing against the learner: once
        ``rlhf.max_episodes_per_version`` episodes completed under one held
        model version, generation waits (bounded by ``rlhf.pace_timeout_s``)
        for a newer swap before continuing — V-trace's clipped-rho
        correction tolerates bounded lag, not unbounded. Returns run stats
        including the arrival-ordered score curve."""
        pace = int(self.params.get("max_episodes_per_version", 0))
        pace_timeout = float(self.params.get("pace_timeout_s", 5.0))
        deadline = time.monotonic() + deadline_s
        pace_version = self.generation.host.version
        pace_done = self.generation.episodes_done
        while (len(self.score_stage.scored_snapshot()) < episodes
               and time.monotonic() < deadline):
            held = self.generation.host.version
            if held != pace_version:
                pace_version, pace_done = held, self.generation.episodes_done
            elif pace and self.generation.episodes_done - pace_done >= pace:
                # Staleness bound hit: wait (briefly) for a newer swap. A
                # timeout without a swap falls through to exactly one round
                # and re-enters this wait — the anchor does not advance, so
                # a stalled learner gets a trickle of fresh episodes, not a
                # pile of stale ones.
                wait_until = min(deadline, time.monotonic() + pace_timeout)
                while (self.generation.host.version == pace_version
                       and time.monotonic() < wait_until):
                    time.sleep(0.005)
                held = self.generation.host.version
                if held != pace_version:
                    pace_version = held
                    pace_done = self.generation.episodes_done
            self.generation.run_round()
        scores = self.score_stage.scored_snapshot()
        return {
            "episodes_scored": len(scores),
            "scores": scores,
            "tokens_generated": self.generation.tokens_generated,
        }

    def flush(self, timeout_s: float = 30.0) -> None:
        """Score and emit everything already terminal; open lane episodes
        are NOT flushed (mid-generation tokens stay local)."""
        self.score_stage.close(timeout_s=timeout_s)

    def close(self) -> None:
        try:
            self.score_stage.close()
        finally:
            if self.agent is not None:
                self.agent.disable_agent()
            host = self.generation.host
            if isinstance(host, _RemoteLanes):
                host.close()  # remote tier: drain the lane worker pool
            for c in self._clients:
                c.disable_agent()
