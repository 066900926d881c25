"""The lazy kernel build is thread-safe: with ``nvcc`` and
``ctypes.CDLL`` stubbed, threads that ask for one library at once build
it exactly once into one file, and the wrappers' lazy initialisers load
once."""

import json
import os
import subprocess
import sys
import threading
import time
from types import SimpleNamespace

import pytest

from raytpu_torch.kernels import (_build, binned, coherence, packet, shade,
                                  strand)
from raytpu_torch.tools import step_bench


@pytest.fixture
def stub_nvcc(tmp_path, monkeypatch):
    """Stub compiler and loader; returns the list of builds (names)."""
    builds = []
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")

    def run(cmd, **kwargs):
        out = cmd[cmd.index("-o") + 1]
        builds.append(os.path.basename(cmd[-3]))
        time.sleep(0.05)  # widen the window a second build would race in
        with open(out, "wb") as f:
            f.write(b"so")
        return subprocess.CompletedProcess(cmd, 0, "ptxas info", "")

    monkeypatch.setattr(_build.subprocess, "run", run)
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: ("lib", path))
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        yield builds
    finally:
        sys.setswitchinterval(old)


def _together(fn, args):
    """Run fn(arg) for each arg on its own thread, started together."""
    go = threading.Barrier(len(args))
    out = [None] * len(args)

    def body(i):
        go.wait(timeout=10)
        out[i] = fn(args[i])

    threads = [threading.Thread(target=body, args=(i,))
               for i in range(len(args))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=20)
    assert not any(t.is_alive() for t in threads)
    return out


def test_two_threads_build_one_library_once(stub_nvcc, tmp_path):
    libs = _together(_build.load_library, ["strand_walk"] * 2)
    assert stub_nvcc == ["strand_walk.cu"]
    so = _build.library_path("strand_walk")
    assert libs == [("lib", so)] * 2
    assert sorted(os.listdir(tmp_path)) == sorted(
        [os.path.basename(so), os.path.basename(so) + ".log"])
    # loaded again: no build
    assert _build.load_library("strand_walk") == ("lib", so)
    assert len(stub_nvcc) == 1


class _FakeLib:
    """Any attribute is a settable stand-in for a ctypes function."""

    def __getattr__(self, name):
        fn = SimpleNamespace()
        object.__setattr__(self, name, fn)
        return fn


@pytest.mark.parametrize("module,arg", [(packet, None), (binned, None),
                                        (strand, "strand_walk"),
                                        (strand, "strand_block"),
                                        (step_bench, None), (shade, None),
                                        (coherence, None)])
def test_lazy_initialisers_load_once(monkeypatch, module, arg):
    loads = []

    def load(name):
        loads.append(name)
        time.sleep(0.05)
        return _FakeLib()

    monkeypatch.setattr(_build, "load_library", load)
    if module is strand:
        monkeypatch.setattr(strand, "_LIBS", {})
    else:
        monkeypatch.setattr(module, "_LIB", None)
    libs = _together(lambda a: module._library(*([a] if a else [])),
                     [arg] * 4)
    assert len(loads) == 1
    assert all(lib is libs[0] for lib in libs)


PTXAS_LOG = """ptxas info    : Compiling entry function '_Z1aPi' for 'sm_90a'
ptxas info    : Function properties for _Z1aPi
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 56 registers, 364 bytes cmem[0]
ptxas info    : Compiling entry function '_Z1bPi' for 'sm_90a'
ptxas info    : Function properties for _Z1bPi
    8 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 63 registers, used 1 barriers, 32 bytes smem, 364 bytes cmem[0]
"""


def test_kernel_resources_reads_ptxas_report(stub_nvcc, monkeypatch):
    """_build.kernel_resources: each kernel's registers, spills and static
    shared memory from the build log's ptxas report (nvcc stubbed)."""
    real = _build.subprocess.run

    def run(cmd, **kwargs):
        real(cmd, **kwargs)  # the stub writes the shared object
        return subprocess.CompletedProcess(cmd, 0, "", PTXAS_LOG)

    monkeypatch.setattr(_build.subprocess, "run", run)
    _build.load_library("strand_walk")
    assert _build.kernel_resources("strand_walk") == {
        "_Z1aPi": dict(registers=56, spill_stores=0, spill_loads=0, smem=0),
        "_Z1bPi": dict(registers=63, spill_stores=8, spill_loads=4,
                       smem=32)}


def test_sass_diff_compares_kernels_by_instructions(monkeypatch, capsys):
    """tools/sass_diff with nvcc and cuobjdump stubbed: each root's cubin
    is disassembled, addresses and comments are dropped, and a kernel
    whose instructions changed is named (exit 1); the same instructions at
    other addresses compare equal (exit 0), also under a new name that the
    old checkout lacks."""
    from raytpu_torch.tools import sass_diff

    sass = {"old": {"k1": ["IADD R1, R2, R3", "EXIT"], "k2": ["EXIT"]},
            "same": {"k1": ["IADD R1, R2, R3", "EXIT"], "k2": ["EXIT"],
                     "k3": ["NOP"]},
            "changed": {"k1": ["IADD R1, R2, R4", "EXIT"], "k2": ["EXIT"]},
            "renamed": {"k1b": ["IADD R1, R2, R3", "EXIT"], "k2": ["EXIT"],
                        "k3": ["NOP"]}}
    built = {}

    def run(cmd, **kwargs):
        if cmd[0] == "nvcc":
            built[cmd[cmd.index("-o") + 1]] = cmd[-1].split(os.sep)[0]
            assert "-shared" not in cmd and "-cubin" in cmd
            return subprocess.CompletedProcess(cmd, 0, "", "")
        lines = []
        for name, code in sass[built[cmd[-1]]].items():
            lines.append(f"\t\tFunction : {name}")
            lines += [f"        /*{16 * i + 48:04x}*/  {op} ;  /* 0x0 */"
                      for i, op in enumerate(code)]
        return subprocess.CompletedProcess(cmd, 0, "\n".join(lines), "")

    monkeypatch.setattr(sass_diff, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(sass_diff.subprocess, "run", run)
    assert sass_diff.main(["--old", "old", "--new", "same",
                           "--sources", "strand_walk"]) == 0
    assert "2 of the old checkout's 2 kernels" in capsys.readouterr().out
    assert sass_diff.main(["--old", "old", "--new", "changed",
                           "--sources", "strand_walk"]) == 1
    assert "differ: ['k1']" in capsys.readouterr().out
    assert sass_diff.main(["--old", "old", "--new", "renamed",
                           "--sources", "strand_walk"]) == 0
    assert "another name: {'k1': 'k1b'}" in capsys.readouterr().out


def test_kernel_sass_reads_addresses(monkeypatch, tmp_path):
    """tools/sass_diff.kernel_sass (nvcc and cuobjdump stubbed): each
    kernel's instructions with addresses and comments dropped, or with
    ``addresses`` (address, instruction) pairs, past 0xffff too, where
    cuobjdump prints five digits; anonymous namespaces lose their
    hashes."""
    from raytpu_torch.tools import sass_diff

    name = ("_ZN46_GLOBAL__N__1a2b3c4d_13_step_bench_cu_5e6f7a8b"
            "10row_kernelILi0EEEvv")
    text = "\n".join([f"\t\tFunction : {name}",
                      "        /*0000*/  MOV R1, c[0x0][0x28] ;  /* 0x0 */",
                      "        /*fff0*/  FADD R2, R1, R1 ;  /* 0x0 */",
                      "        /*10000*/  BRA 0xfff0 ;  /* 0x0 */",
                      "        /*10010*/  EXIT ;  /* 0x0 */"])

    def run(cmd, **kwargs):
        return subprocess.CompletedProcess(cmd, 0, "" if cmd[0] == "nvcc"
                                           else text, "")

    monkeypatch.setattr(sass_diff, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(sass_diff.subprocess, "run", run)
    cubin = str(tmp_path / "k.cubin")
    plain = sass_diff.kernel_sass("root", "step_bench", cubin)
    key = "_ZN25_GLOBAL__N__step_bench_cu10row_kernelILi0EEEvv"
    assert plain == {key: ["MOV R1, c[0x0][0x28] ;", "FADD R2, R1, R1 ;",
                           "BRA 0xfff0 ;", "EXIT ;"]}
    pairs = sass_diff.kernel_sass("root", "step_bench", cubin,
                                  addresses=True)[key]
    assert [a for a, _ in pairs] == [0, 0xfff0, 0x10000, 0x10010]
    assert [i for _, i in pairs] == plain[key]


def test_sass_diff_holds_named_templates_to_stored_digests(
        monkeypatch, capsys, tmp_path):
    """tools/sass_diff's digest file (nvcc stubbed): ``--write-digests``
    stores the old checkout's instances of the ``--only`` templates with
    the nvcc version; ``--digests`` holds a new checkout to it, failing
    (exit 1) only where a held instance changed, never for another
    template's; a file from another nvcc is not compared (exit 2). An
    ``--only`` entry that is a mangled name holds that instance alone."""
    from raytpu_torch.tools import sass_diff

    walk = "_ZN6strand11walk_kernelILi128EEEvNS_4ArgsE"
    sched = "_ZN6strand12sched_kernelILi128EEEvNS_4ArgsE"
    sass = {"old": {walk: ["IADD R1, R2, R3", "EXIT"], sched: ["EXIT"]},
            "same": {walk: ["IADD R1, R2, R3", "EXIT"], sched: ["NOP"]},
            "changed": {walk: ["IADD R1, R2, R4", "EXIT"], sched: ["EXIT"]}}
    built, version = {}, ["Build cuda_12.4.r12.4"]

    def run(cmd, **kwargs):
        if cmd[0] == "nvcc" and "--version" in cmd:
            return subprocess.CompletedProcess(cmd, 0, "nvcc\n" + version[0],
                                               "")
        if cmd[0] == "nvcc":
            built[cmd[cmd.index("-o") + 1]] = cmd[-1].split(os.sep)[0]
            return subprocess.CompletedProcess(cmd, 0, "", "")
        lines = []
        for name, code in sass[built[cmd[-1]]].items():
            lines.append(f"\t\tFunction : {name}")
            lines += [f"        /*{16 * i:04x}*/  {op} ;" for i, op in
                      enumerate(code)]
        return subprocess.CompletedProcess(cmd, 0, "\n".join(lines), "")

    monkeypatch.setattr(sass_diff, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(sass_diff.subprocess, "run", run)
    file = str(tmp_path / "digests.json")
    assert sass_diff.main(["--old", "old", "--new", "same", "--sources",
                           "strand_walk", "--only", "walk_kernel",
                           "--write-digests", file]) == 0
    out = capsys.readouterr().out
    assert "1 of the old checkout's 1 kernels of ['walk_kernel']" in out
    assert sched in out  # listed apart: it changed, and is not held
    with open(file) as f:
        stored = json.load(f)
    assert stored["sources"] == {"strand_walk": {
        walk: sass_diff.digest([f"{op} ;" for op in sass["old"][walk]])}}
    assert sass_diff.main(["--digests", file, "--new", "same"]) == 0
    assert sass_diff.main(["--digests", file, "--new", "changed"]) == 1
    assert f"differ: ['{walk}']" in capsys.readouterr().out
    version[0] = "Build cuda_12.8.r12.8"
    assert sass_diff.main(["--digests", file, "--new", "changed"]) == 2
    # named instances: --only a mangled name holds that instance alone, so
    # a sibling instance of its template may change
    version[0] = "Build cuda_12.4.r12.4"
    wide = "_ZN6strand11walk_kernelILi128ELi4EEEvNS_4ArgsE"
    sass["old"][wide] = ["LDG R1, [R2]", "EXIT"]
    sass["same"][wide] = ["LDS R1, [R2]", "EXIT"]
    sass["changed"][wide] = ["LDG R1, [R2]", "EXIT"]
    assert sass_diff.main(["--old", "old", "--new", "same", "--sources",
                           "strand_walk", "--only", walk, "--write-digests",
                           file]) == 0
    out = capsys.readouterr().out
    assert f"1 of the old checkout's 1 kernels of ['{walk}']" in out
    assert wide in out  # listed apart: it changed, and is not held
    with open(file) as f:
        stored = json.load(f)
    assert stored["only"] == [walk]
    assert list(stored["sources"]["strand_walk"]) == [walk]
    assert sass_diff.main(["--digests", file, "--new", "same"]) == 0
    assert sass_diff.main(["--digests", file, "--new", "changed"]) == 1
    assert f"differ: ['{walk}']" in capsys.readouterr().out
    assert sass_diff.main(["--old", "old", "--new", "same", "--sources",
                           "strand_walk", "--only", "walk_kernel"]) == 1
    assert sass_diff.held(wide, ["walk_kernel"])
    assert not sass_diff.held(wide, [walk, "block_kernel"])


def test_sass_diff_names_anonymous_namespaces_without_build_hashes(
        monkeypatch, capsys):
    """A kernel in an anonymous namespace (packet_walk.cu's, binned_walk.cu's)
    carries hashes that nvcc draws anew at each build: tools/sass_diff names
    it by its source file alone, so two builds of one source compare by
    name and a stored digest names the instance for good."""
    from raytpu_torch.tools import sass_diff

    build = ["_ZN47_GLOBAL__N__ad0c6d20_14_packet_walk_cu_29ada66013packet_"
             "kernelILb0ELb1ELb0ELb0EEEvNS_4ArgsE",
             "_ZN47_GLOBAL__N__33eba951_14_binned_walk_cu_6a00846d13binned_"
             "kernelENS_4ArgsE"]
    assert [sass_diff.canonical(n) for n in build] == [
        "_ZN26_GLOBAL__N__packet_walk_cu13packet_kernelILb0ELb1ELb0ELb0EEEv"
        "NS_4ArgsE", "_ZN26_GLOBAL__N__binned_walk_cu13binned_kernelENS_4"
        "ArgsE"]
    walk = "_ZN6strand11walk_kernelILi128ELb0ELb0ELi0ELb0EEEvNS_4ArgsE"
    assert sass_diff.canonical(walk) == walk
    hashes = iter(["47bc7db5", "d95bb9c4"])

    def run(cmd, **kwargs):
        if cmd[0] == "nvcc":
            return subprocess.CompletedProcess(cmd, 0, "", "")
        name = (f"_ZN47_GLOBAL__N__{next(hashes)}_14_packet_walk_cu_29ada66013"
                "packet_kernelILb0ELb0ELb0ELb0EEEvNS_4ArgsE")
        return subprocess.CompletedProcess(
            cmd, 0, f"\t\tFunction : {name}\n        /*0000*/  EXIT ;", "")

    monkeypatch.setattr(sass_diff, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(sass_diff.subprocess, "run", run)
    assert sass_diff.main(["--old", "a", "--new", "b", "--sources",
                           "packet_walk"]) == 0
    out = capsys.readouterr().out
    assert "1 of the old checkout's 1 kernels" in out
    assert "another name: {}" in out


def test_stored_digests_hold_the_option_free_instances():
    """raytpu_torch/tools/sass_digests.json, which chip_smoke.py's phase 2b
    holds the build to, names walk_kernel's 6 instances without an option,
    block_kernel's 2, packet_kernel's 3 storage-order instances without
    stats (closest, any-hit, mixed) and binned_kernel, each with a digest,
    and holds exactly those."""
    from raytpu_torch.tools import sass_diff

    with open(sass_diff.DIGESTS) as f:
        stored = json.load(f)
    walk = [f"_ZN6strand11walk_kernelILi128ELb{a}ELb{m}ELi{k}ELb0EEEvNS_4"
            "ArgsE" for a, m in ((0, 0), (1, 0), (0, 1)) for k in (0, 1)]
    pk = [f"_ZN26_GLOBAL__N__packet_walk_cu13packet_kernelILb{a}ELb{m}ELb0E"
          "Lb0EEEvNS_4ArgsE" for a, m in ((0, 0), (1, 0), (0, 1))]
    binned_k = "_ZN26_GLOBAL__N__binned_walk_cu13binned_kernelENS_4ArgsE"
    block = [f"_ZN6strand12block_kernelILi128ELb{a}EEEvNS_4ArgsE"
             for a in (0, 1)]
    assert sorted(stored["only"]) == sorted(walk + pk + [binned_k,
                                                         "block_kernel"])
    src = stored["sources"]
    assert sorted(src) == ["binned_walk", "packet_walk", "strand_block",
                           "strand_walk"]
    assert sorted(src["strand_walk"]) == sorted(walk)
    assert sorted(src["strand_block"]) == sorted(block)
    assert sorted(src["packet_walk"]) == sorted(pk)
    assert list(src["binned_walk"]) == [binned_k]
    assert all(len(d) == 64 for s in src.values() for d in s.values())
    assert stored["nvcc"].startswith("Build cuda_")
