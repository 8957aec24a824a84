#!/usr/bin/env python3
"""Where a Python script's host time goes: run it under a sampler of its
main thread's stack.

    python3 tools/sample_stacks.py [--out FILE] [--interval S] \\
        -- SCRIPT [ARGS ...]
    python3 tools/sample_stacks.py -- chip_smoke.py     # on the card

Every ``--interval`` seconds (default 0.25) a thread reads the main
thread's stack. When the script ends (or raises), ``--out`` (default
``chiprun_out/stack_samples.txt``) gets, as seconds = samples ×
interval: the lines of SCRIPT that were on the stack (cumulative), the
functions that were on it (cumulative), and the innermost lines (own
time). A wait on the card shows up in the line that waits. The sampler
costs a stack walk per sample and nothing between samples; the script's
exit code is its own.
"""
from __future__ import annotations

import argparse
import collections
import os
import runpy
import sys
import threading
import time


def short(path):
    for mark in ("/site-packages/", os.getcwd() + os.sep):
        if mark in path:
            return path.split(mark, 1)[1]
    return path


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="chiprun_out/stack_samples.txt")
    ap.add_argument("--interval", type=float, default=0.25)
    ap.add_argument("script")
    ap.add_argument("args", nargs=argparse.REMAINDER)
    a = ap.parse_args(argv)
    script = os.path.abspath(a.script)
    lines, funcs, own = (collections.Counter() for _ in range(3))
    main_id = threading.get_ident()
    done = threading.Event()

    def sample():
        while not done.wait(a.interval):
            f = sys._current_frames().get(main_id)
            seen_lines, seen_funcs = set(), set()
            if f is not None:
                own[f"{short(f.f_code.co_filename)}:{f.f_lineno} "
                    f"{f.f_code.co_name}"] += 1
            while f is not None:
                code = f.f_code
                if code.co_filename == script:
                    seen_lines.add(f"{os.path.basename(script)}:"
                                   f"{f.f_lineno} {code.co_name}")
                seen_funcs.add(f"{short(code.co_filename)}:"
                               f"{code.co_firstlineno} {code.co_name}")
                f = f.f_back
            lines.update(seen_lines)
            funcs.update(seen_funcs)

    def dump():
        os.makedirs(os.path.dirname(a.out) or ".", exist_ok=True)
        s = a.interval
        with open(a.out, "w") as fh:
            fh.write(f"# seconds = samples x {s}\n## lines of "
                     f"{os.path.basename(script)} on the stack\n")
            for k, n in lines.most_common():
                if n * s >= 1.0:
                    fh.write(f"{n * s:9.2f}  {k}\n")
            fh.write("## functions on the stack\n")
            for k, n in funcs.most_common(250):
                fh.write(f"{n * s:9.2f}  {k}\n")
            fh.write("## innermost lines\n")
            for k, n in own.most_common(120):
                fh.write(f"{n * s:9.2f}  {k}\n")

    sys.argv = [script] + a.args
    sys.path.insert(0, os.path.dirname(script))
    threading.Thread(target=sample, daemon=True).start()
    t0 = time.perf_counter()
    try:
        runpy.run_path(script, run_name="__main__")
    finally:
        done.set()
        dump()
        print(f"[sample_stacks] {time.perf_counter() - t0:.1f}s sampled "
              f"every {a.interval}s -> {a.out}", file=sys.stderr)


if __name__ == "__main__":
    main()
