"""Registers, shared memory, stack and spills of each CUDA kernel.

    python -m bulletproofspp_tpu_torch.tools.ptxas_usage [kernels.cu tools.cu ...]
    python -m bulletproofspp_tpu_torch.tools.ptxas_usage --sass SOURCE NAME [NAME ...] [--dump DIR]

Compiles the named sources of ``csrc/`` (default: every source of
``ops.kernels.SOURCES``) with the flags the port builds with plus
``-Xptxas -v``, one nvcc process per source, all at once, into a
temporary directory, and prints one line per compiled function: registers
a thread, static shared memory, stack frame and spill stores and loads
in bytes.  With ``--sass``: the SASS of the built library of SOURCE
(``ops.kernels.build``; ``cuobjdump -sass``), for each NAME the first
kernel whose demangled name holds it (``"fold_many_kernel<16, false>"``)
a line of its instruction count and its counts by opcode
(the commonest, and every opcode of ``SASS_WATCH``) and a line for each
of its three largest loops (by backward branch: an outer loop holds its
inner ones); then, for the first two NAMEs, the opcodes whose counts
differ, in all and in their largest loops; ``--dump DIR`` writes each
kernel's SASS there.  Needs nvcc, not a card; exits 1
if nvcc fails.
"""

from __future__ import annotations

import os
import re
import shutil
import subprocess
import sys
import tempfile
from collections import Counter

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


_FUNCTION = re.compile(r"^\s*Function : (\S+)")
_INSN = re.compile(r"^\s*/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_]*)(.*)")
_TARGET = re.compile(r"0x([0-9a-f]+)")
# opcodes a round's parts issue: the products' multiply-adds, the carry
# chains' additions, selects, shuffles, shared-memory loads, local memory
SASS_WATCH = ("IMAD", "IADD3", "SEL", "SHFL", "LDS", "STS", "LDL", "STL", "BRA", "ISETP")


def sass_functions(text: str) -> dict:
    """``cuobjdump -sass`` output -> {mangled function: [(address, opcode
    without modifiers, branch target or None), ...]}."""
    out: dict = {}
    cur = None
    for line in text.splitlines():
        if m := _FUNCTION.search(line):
            cur = out.setdefault(m.group(1), [])
        elif cur is not None and (m := _INSN.search(line)):
            op, target = m.group(2), None
            if op == "BRA" and (t := _TARGET.search(m.group(3).split(";")[0])):
                target = int(t.group(1), 16)
            cur.append((int(m.group(1), 16), op, target))
    return out


def sass_loops(insns) -> list:
    """The loops of one function, by its backward branches: [(first
    address, branch's address, Counter of the opcodes between them)],
    largest first (an outer loop holds its inner loops' instructions)."""
    loops = []
    for addr, _, target in insns:
        if target is not None and target <= addr:
            loops.append((target, addr, Counter(op for a, op, _ in insns if target <= a <= addr)))
    return sorted(loops, key=lambda lp: -sum(lp[2].values()))


def sass(source: str, prefixes, dump: str | None = None) -> dict:
    """{demangled kernel: its ``sass_functions`` list} for the kernels of
    SOURCE's built library whose demangled names hold one of ``prefixes``;
    with ``dump``, each one's SASS text is also written there."""
    so = kernels.build()[source]
    tool = os.path.join(os.path.dirname(kernels._nvcc()), "cuobjdump")
    text = subprocess.run([tool, "-sass", so], capture_output=True, text=True, check=True).stdout
    by_name = sass_functions(text)
    names = _demangle(list(by_name))
    found = {names[n]: v for n, v in by_name.items() if any(p in names[n] for p in prefixes)}
    if dump:
        os.makedirs(dump, exist_ok=True)
        for part in text.split("Function : ")[1:]:
            name = names.get(part.split()[0], "")
            if name in found:
                with open(os.path.join(dump, re.sub(r"\W+", "_", name)[:80] + ".sass"), "w") as f:
                    f.write("Function : " + part)
    return found


def _watch(c: Counter) -> str:
    return f"{sum(c.values())} instructions; " + ", ".join(f"{op} {c[op]}" for op in SASS_WATCH)


def _sass_main(source: str, prefixes, dump=None) -> int:
    found = sass(source, prefixes, dump)
    picked = [next((n for n in found if p in n), None) for p in prefixes]
    loops = {}
    for name in filter(None, picked):
        insns = found[name]
        c = Counter(op for _, op, _ in insns)
        loops[name] = sass_loops(insns)
        common = ", ".join(f"{op} {k}" for op, k in c.most_common(12))
        print(f"sass {name[:80]}: {_watch(c)}; commonest {common}", flush=True)
        for first, last, lc in loops[name][:3]:
            print(f"  loop {first:#07x}-{last:#07x}: {_watch(lc)}", flush=True)
    if len(picked) >= 2 and all(picked[:2]):
        for what, (a, b) in (("all", [Counter(op for _, op, _ in found[n]) for n in picked[:2]]),
                             ("largest loop", [loops[n][0][2] if loops[n] else Counter()
                                               for n in picked[:2]])):
            diff = sorted(((op, a[op], b[op]) for op in set(a) | set(b) if a[op] != b[op]),
                          key=lambda t: -abs(t[1] - t[2]))
            print(f"sass difference ({what}) {picked[0][:50]} / {picked[1][:50]}: "
                  + ", ".join(f"{op} {x} / {y}" for op, x, y in diff), flush=True)
    return 0 if all(picked) else 1


def main(argv=None) -> int:
    args = list(argv if argv is not None else sys.argv[1:])
    if args[:1] == ["--sass"]:
        dump = None
        if "--dump" in args:
            i = args.index("--dump")
            dump, args = args[i + 1], args[:i] + args[i + 2:]
        return _sass_main(args[1], args[2:], dump)
    sources = args or list(kernels.SOURCES)
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
