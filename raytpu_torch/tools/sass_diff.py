"""Compare the machine code of two checkouts' CUDA kernels, kernel by
kernel.

    python -m raytpu_torch.tools.sass_diff --old PARENT [--new .] \
        [--sources strand_walk strand_block] [--only walk_kernel ...] \
        [--write-digests FILE]
    python -m raytpu_torch.tools.sass_diff --digests FILE [--new .]

Each root is the top of a checkout (the directory that holds
``raytpu_torch/``). For each source, both checkouts' ``csrc/<source>.cu``
are compiled to sm_90a cubins with the port's nvcc flags
(``kernels/_build.py:NVCC_FLAGS``, without those of a shared object) and
disassembled with ``cuobjdump -sass``; each kernel's instructions are
compared with addresses and comments stripped. An old kernel is paired
with the new kernel of the same mangled name, or, where the new checkout
has none (a template parameter that changed type, as bool to int, renames
every instance), with a kernel of a name the old checkout lacks and the
same instructions. A kernel in an anonymous namespace is named without
the hashes nvcc puts in that namespace's name, which change from one
build to the next (``_ZN47_GLOBAL__N__<hash>_14_packet_walk_cu_<hash>13
packet_kernel...`` becomes ``_ZN26_GLOBAL__N__packet_walk_cu13
packet_kernel...``). Prints, per source, how many of the old checkout's
kernels the new one compiles to the same instructions, those found under
another name, and which differ, and exits 1 if any differ. ``--only``
holds only the instances of the named kernel templates (e.g.
``walk_kernel block_kernel``) and the kernels named by their mangled
names (an entry that starts with ``_Z``, e.g. one instance of a
template); the others are listed apart and never fail the run.

``--write-digests FILE`` stores the held kernels' digests (SHA-256 of the
instructions) of the old checkout (or of the new one, without ``--old``)
with the nvcc version, the sources and the templates held; ``--digests
FILE`` holds the new checkout to such a file instead of to a second
checkout, with its sources and templates, and exits 2 without comparing
when the file was written by another nvcc (instructions are only
comparable from one compiler). ``raytpu_torch/tools/sass_digests.json``
holds the instructions of walk_kernel's 6 instances without an option
(strand and ribbon rows one record a step, closest / any-hit / mixed,
no stats) and of block_kernel's 2, as the commit before walk_kernel's
K-wide fetch and stats counters were redesigned compiled them, and of
packet_kernel's 3 storage-order instances without stats and
binned_kernel, as the commit before packet_kernel's near-first order and
stats counters were redesigned compiled them, for chip_smoke.py's check
that those instances kept their code. Needs nvcc and cuobjdump (the CUDA
toolkit), not a GPU.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import re
import subprocess
import sys
import tempfile

from ..kernels._build import NVCC_FLAGS, _nvcc

_SHARED = {"-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"}
DIGESTS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "sass_digests.json")


def canonical(name: str) -> str:
    """The mangled kernel ``name`` with its anonymous namespace (if any)
    named by its source file alone, without nvcc's per-build hashes."""
    m = re.search(r"(\d+)_GLOBAL__N__", name)
    if m is None:
        return name
    end = m.end(1) + int(m.group(1))
    ident = name[m.end(1):end]
    f = re.match(r"_GLOBAL__N__[0-9a-f]+_(\d+)_", ident)
    if f is None:
        return name
    ns = "_GLOBAL__N__" + ident[f.end():f.end() + int(f.group(1))]
    return f"{name[:m.start(1)]}{len(ns)}{ns}{name[end:]}"


def kernel_sass(root: str, source: str, cubin: str,
                addresses: bool = False) -> dict:
    """{mangled kernel name: [instruction, ...]} of ``root``'s
    ``csrc/<source>.cu``, compiled to the file ``cubin``; with
    ``addresses``, [(address, instruction), ...]."""
    src = os.path.join(root, "raytpu_torch", "kernels", "csrc", source + ".cu")
    flags = [f for f in NVCC_FLAGS if f not in _SHARED]
    subprocess.run([_nvcc(), *flags, "-cubin", "-o", cubin, src], check=True)
    cuobjdump = os.path.join(os.path.dirname(_nvcc()), "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", cubin], capture_output=True,
                          text=True, check=True).stdout
    kernels, name = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = canonical(m.group(1))
            kernels[name] = []
        elif name and (m := re.match(r"\s*/\*([0-9a-f]{4,})\*/", line)):
            ins = re.sub(r"/\*.*?\*/", "", line).strip()
            kernels[name].append((int(m.group(1), 16), ins) if addresses
                                 else ins)
    return kernels


def digest(instructions: list) -> str:
    return hashlib.sha256("\n".join(instructions).encode()).hexdigest()


def held(name: str, only) -> bool:
    """Whether the mangled kernel ``name`` is one of ``only``: a template
    name holds its instances, a mangled name (``_Z...``) that kernel; all
    kernels when None."""
    return only is None or any(
        name == t if t.startswith("_Z") else f"{len(t)}{t}I" in name
        for t in only)


def compare(old: dict, new: dict) -> tuple:
    """({old name: new name} paired by instructions under another name,
    [old names that differ]) of two {name: digest} maps."""
    renamed, bad = {}, []
    for k in old:
        if new.get(k) == old[k]:
            continue
        twins = [n for n in new if n not in old and new[n] == old[k]
                 and n not in renamed.values()]
        if k not in new and twins:
            renamed[k] = twins[0]
        else:
            bad.append(k)
    return renamed, bad


def nvcc_version() -> str:
    out = subprocess.run([_nvcc(), "--version"], capture_output=True,
                         text=True, check=True).stdout
    return out.strip().splitlines()[-1]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--old", default=None)
    p.add_argument("--new", default=".")
    p.add_argument("--sources", nargs="+",
                   default=["strand_walk", "strand_block"])
    p.add_argument("--only", nargs="+", default=None,
                   help="kernel templates, or mangled kernel names, to hold "
                        "(default: every kernel)")
    p.add_argument("--digests", default=None,
                   help="hold --new to this digest file, not to --old")
    p.add_argument("--write-digests", default=None,
                   help="store the held kernels' digests of --old (else "
                        "--new) in this file")
    args = p.parse_args(argv)
    stored = None
    if args.digests:
        with open(args.digests) as f:
            stored = json.load(f)
        if stored["nvcc"] != nvcc_version():
            print(f"sass_diff: {args.digests} was written by nvcc "
                  f"{stored['nvcc']!r}, this is {nvcc_version()!r}: not "
                  "comparable")
            return 2
        args.sources, args.only = list(stored["sources"]), stored["only"]
    elif args.old is None and args.write_digests is None:
        p.error("give --old, --digests or --write-digests")
    differ = False
    written = {}
    with tempfile.TemporaryDirectory() as tmp:
        for source in args.sources:
            roots = [("new", args.new)]
            if args.old is not None:
                roots.insert(0, ("old", args.old))
            got = {tag: {k: digest(v) for k, v in kernel_sass(
                root, source, os.path.join(tmp, f"{tag}_{source}.cubin"))
                .items()} for tag, root in roots}
            new = got["new"]
            old = stored["sources"][source] if stored else got.get("old")
            if args.write_digests:
                mine = got.get("old", new)
                written[source] = {k: v for k, v in mine.items()
                                   if held(k, args.only)}
            if old is None:
                continue
            hold_old = {k: v for k, v in old.items() if held(k, args.only)}
            renamed, bad = compare(hold_old, new)
            free = sorted(k for k in new if not held(k, args.only))
            differ = differ or bool(bad)
            print(f"{source}.cu: {len(hold_old) - len(bad)} of the "
                  f"{'stored digests' if stored else 'old checkout'}'s "
                  f"{len(hold_old)} kernels"
                  + (f" of {args.only}" if args.only else "")
                  + f" compile to the same instructions ({len(new)} kernels "
                  f"in the new checkout; under another name: {renamed}); "
                  f"differ: {bad}"
                  + (f"; not held, differing from the old checkout: "
                     f"{[k for k in free if old.get(k) != new[k]]}"
                     if args.only and not stored else ""))
    if args.write_digests:
        with open(args.write_digests, "w") as f:
            json.dump({"nvcc": nvcc_version(), "only": args.only,
                       "sources": written}, f, indent=1, sort_keys=True)
            f.write("\n")
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
