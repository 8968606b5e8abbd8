"""Registers, shared memory, stack and spills of each CUDA kernel.

    python -m bulletproofspp_tpu_torch.tools.ptxas_usage [kernels.cu tools.cu ...]

Compiles the named sources of ``csrc/`` (default: every source of
``ops.kernels.SOURCES``) with the flags the port builds with plus
``-Xptxas -v``, one nvcc process per source, all at once, into a
temporary directory, and prints one line per compiled function: registers
a thread, static shared memory, stack frame and spill stores and loads
in bytes.  Needs nvcc, not a card; exits 1 if nvcc fails.
"""

from __future__ import annotations

import os
import re
import shutil
import subprocess
import sys
import tempfile

from ..ops import kernels

_ENTRY = re.compile(r"Compiling entry function '([^']+)'")
_PROPS = re.compile(r"Function properties for (\S+)")
_FRAME = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads")
_USED = re.compile(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?")


def parse(log: str) -> dict:
    """ptxas -v output -> {mangled name: {registers, smem, stack, spill_stores,
    spill_loads}} (registers and smem for entry functions only)."""
    out: dict = {}
    entry = props = None
    for line in log.splitlines():
        if m := _ENTRY.search(line):
            entry = m.group(1)
        elif m := _PROPS.search(line):
            props = m.group(1)
        elif (m := _FRAME.search(line)) and props:
            out.setdefault(props, {}).update(
                stack=int(m.group(1)), spill_stores=int(m.group(2)), spill_loads=int(m.group(3)))
        elif (m := _USED.search(line)) and entry:
            out.setdefault(entry, {}).update(registers=int(m.group(1)), smem=int(m.group(2) or 0))
    return out


def _demangle(names):
    if not names or not shutil.which("c++filt"):
        return {n: n for n in names}
    res = subprocess.run(["c++filt"], input="\n".join(names), capture_output=True, text=True)
    return dict(zip(names, res.stdout.splitlines()))


def usage(sources) -> dict:
    """{source: (nvcc's return code, its log, {demangled name: parse's
    entry})} for the named sources of ``csrc/``, one nvcc process each, all
    at once (``chip_smoke.py`` runs it beside the build)."""
    nvcc = kernels._nvcc()
    with tempfile.TemporaryDirectory() as tmp:
        procs = {
            src: subprocess.Popen(
                [nvcc, *kernels.NVCC_FLAGS, "-Xptxas", "-v", "-o", os.path.join(tmp, f"{i}.so"),
                 os.path.join(kernels.CSRC, src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for i, src in enumerate(sources)
        }
        logs = {src: p.communicate()[0] for src, p in procs.items()}
    out = {}
    for src, log in logs.items():
        parsed = parse(log) if procs[src].returncode == 0 else {}
        names = _demangle(list(parsed))
        out[src] = (procs[src].returncode, log, {names[n]: u for n, u in parsed.items()})
    return out


def main(argv=None) -> int:
    sources = list(argv if argv is not None else sys.argv[1:]) or list(kernels.SOURCES)
    rc = 0
    for src, (code, log, by_name) in usage(sources).items():
        if code != 0:
            print(f"{src}: nvcc failed ({code}):\n{log}", file=sys.stderr)
            rc = 1
            continue
        for name, u in by_name.items():
            print(f"{src} {name[:90]:90s} registers {u.get('registers', '-')}  smem "
                  f"{u.get('smem', '-')} B  stack {u.get('stack', '-')} B  spill stores "
                  f"{u.get('spill_stores', '-')} B  loads {u.get('spill_loads', '-')} B", flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
