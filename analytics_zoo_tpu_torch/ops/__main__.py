"""Incident CLI: ``python -m analytics_zoo_tpu_torch.ops <command>``.

Reads a fleet's shared event spool (the directory every process was
pointed at with ``ops.dir``) without joining it: the CLI's ``EventLog`` is
disabled, so it never writes a part file of its own.

Commands::

    # the causally ordered timeline of the last 10 minutes
    python -m analytics_zoo_tpu_torch.ops timeline --events /tmp/fleet_ops --since-s 600

    # seal an incident bundle on demand (events and health snapshots)
    python -m analytics_zoo_tpu_torch.ops seal --events /tmp/fleet_ops \
        --reason manual-probe --health /tmp/fleet_health

    # re-render a sealed bundle
    python -m analytics_zoo_tpu_torch.ops show /tmp/fleet_ops/incidents/incident-...
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

from . import incident as _incident
from .events import EventLog


def _read_only_log(root: str) -> EventLog:
    # enabled=False: a forensic reader must never write the spool it reads
    return EventLog(root=root, enabled=False)


def _cmd_timeline(args: argparse.Namespace) -> int:
    log = _read_only_log(args.events)
    since = None
    if args.since_s is not None:
        newest = log.read()
        if newest:
            since = newest[-1].get("wall", 0.0) - float(args.since_s)
    evs = _incident.order_events(log.read(since_wall=since))
    sys.stdout.write(_incident.render_timeline(evs))
    return 0


def _cmd_seal(args: argparse.Namespace) -> int:
    log = _read_only_log(args.events)
    corr = _incident.IncidentCorrelator(
        log=log, out_dir=args.out, window_s=args.window_s,
        health_paths=args.health or ())
    path = corr.seal(reason=args.reason)
    sys.stdout.write(path + "\n")
    return 0


def _cmd_show(args: argparse.Namespace) -> int:
    bundle = _incident.load_bundle(args.bundle)
    if args.json:
        json.dump(bundle, sys.stdout, indent=2, default=str)
        sys.stdout.write("\n")
    else:
        sys.stdout.write(_incident.render_timeline(
            bundle.get("events", []), reason=bundle.get("reason"),
            alert=bundle.get("alert")))
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m analytics_zoo_tpu_torch.ops",
        description="Incident correlator CLI over a shared event spool.")
    sub = p.add_subparsers(dest="cmd", required=True)

    t = sub.add_parser("timeline",
                       help="render the causally-ordered event timeline")
    t.add_argument("--events", required=True,
                   help="event spool directory (the fleet's ops.dir)")
    t.add_argument("--since-s", type=float, default=None,
                   help="only the trailing N seconds (default: everything)")
    t.set_defaults(fn=_cmd_timeline)

    s = sub.add_parser("seal", help="seal an on-demand incident bundle")
    s.add_argument("--events", required=True,
                   help="event spool directory (the fleet's ops.dir)")
    s.add_argument("--out", default=None,
                   help="bundle output dir (default: <events>/incidents)")
    s.add_argument("--reason", default="manual")
    s.add_argument("--window-s", type=float, default=None,
                   help="event window to seal (default: ops.incident_window_s)")
    s.add_argument("--health", nargs="*", default=None,
                   help="health.json files or directories to freeze in")
    s.set_defaults(fn=_cmd_seal)

    w = sub.add_parser("show", help="re-render a sealed bundle")
    w.add_argument("bundle",
                   help="bundle directory or its bundle.json")
    w.add_argument("--json", action="store_true",
                   help="dump the raw bundle JSON instead of the timeline")
    w.set_defaults(fn=_cmd_show)
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    return int(args.fn(args))


if __name__ == "__main__":  # pragma: no cover - exercised via subprocess
    sys.exit(main())
