"""Command-line switches of the benches, each defaulting to the
`STFEM_BENCH_*` variable of bench.py that it ports, so that a bench.py
command line carries over.  Only the entry points' main() pass the
environment in; run() takes plain keyword arguments."""
from __future__ import annotations

import argparse
from dataclasses import dataclass
from typing import Callable


@dataclass(frozen=True)
class Switch:
    """One switch: --`name` on the command line, the variable `env`,
    the run() keyword `arg`; `kind` is "bool" (a --name / --no-name pair;
    the variable is on when it is "1", as bench.py reads it) or the
    parser of a value; `default` when neither is given."""
    name: str
    env: str
    arg: str
    kind: Callable | str
    default: object
    help: str = ""


def reorth_value(raw: str):
    """bench.py's STFEM_BENCH_REORTH: "1" two Gram-Schmidt passes, "0"
    one, "selective" the DGKS test ("gram" is stfem_tpu's spelling of
    two passes)."""
    if raw in ("selective", "gram"):
        return "selective" if raw == "selective" else True
    if raw in ("0", "1"):
        return raw == "1"
    raise argparse.ArgumentTypeError(f"reorth: 0, 1, selective or gram, "
                                     f"not {raw!r}")


def _parse(s: Switch, raw: str):
    return raw == "1" if s.kind == "bool" else s.kind(raw)


def add_switches(parser: argparse.ArgumentParser, switches, environ,
                 prefix: str = "") -> None:
    """Add --`prefix``name` for each switch, its default read from
    environ[s.env] where that is set and not empty."""
    for s in switches:
        raw = environ.get(s.env, "")
        default = s.default if raw == "" else _parse(s, raw)
        flag = "--" + prefix + s.name
        dest = (prefix + s.arg).replace("-", "_")
        text = f"{s.help} ({s.env}; default {default!r})"
        if s.kind == "bool":
            parser.add_argument(flag, dest=dest, default=default, help=text,
                                action=argparse.BooleanOptionalAction)
        else:
            parser.add_argument(flag, dest=dest, default=default, help=text,
                                type=s.kind)


def switch_kwargs(args: argparse.Namespace, switches,
                  prefix: str = "") -> dict:
    """The run() keywords of the parsed switches."""
    return {s.arg: getattr(args, (prefix + s.arg).replace("-", "_"))
            for s in switches}
