"""Compare the machine code of two checkouts' CUDA kernels, kernel by
kernel.

    python -m raytpu_torch.tools.sass_diff --old PARENT [--new .] \
        [--sources strand_walk strand_block]

Each root is the top of a checkout (the directory that holds
``raytpu_torch/``). For each source, both checkouts' ``csrc/<source>.cu``
are compiled to sm_90a cubins with the port's nvcc flags
(``kernels/_build.py:NVCC_FLAGS``, without those of a shared object) and
disassembled with ``cuobjdump -sass``; each kernel's instructions are
compared with addresses and comments stripped. An old kernel is paired
with the new kernel of the same mangled name, or, where the new checkout
has none (a template parameter that changed type, as bool to int, renames
every instance), with a kernel of a name the old checkout lacks and the
same instructions. Prints, per source, how many of the old checkout's
kernels the new one compiles to the same instructions, those found under
another name, and which differ, and exits 1 if any differ. Needs nvcc and
cuobjdump (the CUDA toolkit), not a GPU.
"""

from __future__ import annotations

import argparse
import os
import re
import subprocess
import sys
import tempfile

from ..kernels._build import NVCC_FLAGS, _nvcc

_SHARED = {"-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"}


def kernel_sass(root: str, source: str, cubin: str) -> dict:
    """{mangled kernel name: [instruction, ...]} of ``root``'s
    ``csrc/<source>.cu``, compiled to the file ``cubin``."""
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
            name = m.group(1)
            kernels[name] = []
        elif name and re.match(r"\s*/\*[0-9a-f]{4}\*/", line):
            kernels[name].append(re.sub(r"/\*.*?\*/", "", line).strip())
    return kernels


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--old", required=True)
    p.add_argument("--new", default=".")
    p.add_argument("--sources", nargs="+",
                   default=["strand_walk", "strand_block"])
    args = p.parse_args(argv)
    differ = False
    with tempfile.TemporaryDirectory() as tmp:
        for source in args.sources:
            old, new = (kernel_sass(root, source,
                                    os.path.join(tmp, f"{tag}_{source}.cubin"))
                        for tag, root in (("old", args.old),
                                          ("new", args.new)))
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
            differ = differ or bool(bad)
            print(f"{source}.cu: {len(old) - len(bad)} of the old checkout's "
                  f"{len(old)} kernels compile to the same instructions "
                  f"({len(new)} kernels in the new one; under another name: "
                  f"{renamed}); differ: {bad}")
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
