"""A port ``VectorAgent`` in a process of its own, for the fleet drill in
``tests/test_torch_fleet.py``: it plays episodes on random observations
against a live server (fleet plane on, so its registry ships to the root
every ``telemetry.fleet_interval_s``) until the stop file appears, then
disables the agent (the final snapshot frame) and writes its registry's
final snapshot to ``result_path``.

    python tests/_torch_fleet_worker.py '<json>'

keys: ``config_path``, ``identity``, ``lanes``, ``seed``, ``ready_path``,
``stop_path``, ``result_path`` and the ZMQ agent addresses.
"""

import json
import os
import sys
import time

import numpy as np


def main() -> None:
    cfg = json.loads(sys.argv[1])
    from relayrl_tpu_torch import telemetry
    from relayrl_tpu_torch.runtime.agent import VectorAgent

    addrs = {k: cfg[k] for k in ("agent_listener_addr", "trajectory_addr",
                                 "model_sub_addr")}
    agent = VectorAgent(num_envs=cfg["lanes"], config_path=cfg["config_path"],
                        seed=cfg["seed"], identity=cfg["identity"],
                        probe=False, device="cpu", **addrs)
    rng = np.random.default_rng(cfg["seed"])
    with open(cfg["ready_path"], "w") as f:
        f.write("ready")
    while not os.path.exists(cfg["stop_path"]):
        for _ in range(3):
            agent.request_for_actions(
                rng.standard_normal((cfg["lanes"], 4)).astype(np.float32))
        for lane in range(cfg["lanes"]):
            agent.flag_last_action(lane, 1.0, terminated=True)
        time.sleep(0.02)
    agent.disable_agent()
    with open(cfg["result_path"], "w") as f:
        json.dump({"identity": cfg["identity"],
                   "snapshot": telemetry.get_registry().snapshot()}, f)


if __name__ == "__main__":
    main()
