"""``python -m relayrl_tpu_torch.relay`` — run one relay node as a process.

Counterpart of ``python -m relayrl_tpu.relay``, with the same flags.

Two configuration surfaces:

* human flags (``--upstream-type zmq --upstream-listener tcp://... ``
  etc.) layered over the ``relay.*`` config section, for operators;
* ``--json '{...}'`` — a dict of :class:`RelayNode` ctor kwargs, for
  callers (benches, tests) that already hold the topology as data.

The process relays until ``--duration`` lapses, ``--stop-file``
appears, or SIGTERM/SIGINT arrives; on the way out it flushes the
spool, and with ``--result-path`` writes a JSON result (relay stats +
the full telemetry snapshot in the production ``/snapshot`` schema) for
the caller to embed — the bench's relay-counter evidence.
"""

from __future__ import annotations

import argparse
import json
import signal
import sys


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m relayrl_tpu_torch.relay",
        description="one hop of the hierarchical relay tree")
    parser.add_argument("--json", default=None,
                        help="RelayNode ctor kwargs as a JSON object "
                             "(caller surface; flags below override)")
    parser.add_argument("--config", default=None, help="config file path")
    parser.add_argument("--name", default=None)
    parser.add_argument("--upstream-type", default=None,
                        choices=("zmq", "grpc", "native", "auto"))
    parser.add_argument("--upstream-listener", default=None,
                        help="parent agent_listener addr (zmq)")
    parser.add_argument("--upstream-trajectory", default=None,
                        help="parent trajectory addr (zmq)")
    parser.add_argument("--upstream-model", default=None,
                        help="parent model pub addr (zmq)")
    parser.add_argument("--upstream-server", default=None,
                        help="parent server addr (grpc/native)")
    parser.add_argument("--downstream-type", default=None,
                        choices=("zmq", "grpc"))
    parser.add_argument("--fanout-port", type=int, default=None,
                        help="bind the zmq fan-out triple at this base "
                             "port (listener, +1 trajectory, +2 model)")
    parser.add_argument("--spool-dir", default=None)
    parser.add_argument("--batch-max", type=int, default=None)
    parser.add_argument("--duration", type=float, default=None,
                        help="relay for this many seconds then exit")
    parser.add_argument("--stop-file", default=None,
                        help="exit when this file appears")
    parser.add_argument("--ready-file", default=None,
                        help="touch this file once the relay is serving")
    parser.add_argument("--result-path", default=None,
                        help="write stats + telemetry snapshot here on exit")
    parser.add_argument("--no-telemetry", action="store_true",
                        help="skip installing a live metrics registry")
    args = parser.parse_args(argv)

    kwargs: dict = {}
    if args.json:
        kwargs.update(json.loads(args.json))
    if args.config:
        kwargs["config_path"] = args.config
    if args.name:
        kwargs["name"] = args.name
    if args.upstream_type:
        kwargs["upstream_type"] = args.upstream_type
    upstream = dict(kwargs.get("upstream") or {})
    if args.upstream_listener:
        upstream["agent_listener_addr"] = args.upstream_listener
    if args.upstream_trajectory:
        upstream["trajectory_addr"] = args.upstream_trajectory
    if args.upstream_model:
        upstream["model_sub_addr"] = args.upstream_model
    if args.upstream_server:
        upstream["server_addr"] = args.upstream_server
    if upstream:
        kwargs["upstream"] = upstream
    if args.downstream_type:
        kwargs["downstream_type"] = args.downstream_type
    if args.fanout_port is not None:
        kwargs["fanout_port"] = args.fanout_port
    if args.spool_dir:
        kwargs["spool_dir"] = args.spool_dir
    if args.batch_max is not None:
        kwargs["batch_max"] = args.batch_max

    from relayrl_tpu_torch import telemetry

    if not args.no_telemetry:
        # A live registry regardless of config telemetry.enabled: the
        # relay's result file must carry its counters (the bench/test
        # workers' chaos_telemetry convention).
        telemetry.set_registry(telemetry.Registry(
            run_id=f"relay-{kwargs.get('name') or 'node'}"))

    from relayrl_tpu_torch.relay import RelayNode

    node = RelayNode(**kwargs)

    stopping = []

    def _stop_signal(signum, frame):
        stopping.append(signum)
        node._stop.set()

    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            signal.signal(sig, _stop_signal)
        except ValueError:
            pass  # not the main thread (embedded use)

    if args.ready_file:
        with open(args.ready_file, "w") as f:
            f.write(node.name)
    print(f"[relay/{node.name}] relaying "
          f"(upstream={node.upstream_type}, "
          f"downstream={node.downstream_type})", flush=True)
    try:
        node.run(duration_s=args.duration, stop_file=args.stop_file)
    finally:
        stats = node.stats()
        node.close()
        if args.result_path:
            result = {"relay": node.name, "stats": stats,
                      "telemetry": telemetry.get_registry().snapshot()}
            with open(args.result_path, "w") as f:
                json.dump(result, f)
        print(f"[relay/{node.name}] down: {json.dumps(stats)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
