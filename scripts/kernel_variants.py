"""Kernel variants for the probes in this directory.

A probe that asks where a kernel's time goes builds copies of one of the
port's CUDA sources with a part cut out by a textual edit, binds each in
place of the library the wrappers call, and times the wrappers; a probe
that compares with an older tree builds that tree's source beside the
repo's.  These helpers do the building (nvcc with the port's flags, all
sources compiled in parallel) and the swap.  The probes import this module
from their own directory (`python scripts/<probe>.py` puts it on the
path).
"""
from __future__ import annotations

import contextlib
import ctypes
import subprocess


def start(_build, name, cu):
    """(the .so path, the running nvcc) for source `cu`, built with the
    port's flags into build/<name>.so; csrc/ is on the include path, so a
    copy of a source in any directory finds the port's headers."""
    out = _build.BUILD / f"{name}.so"
    _build.BUILD.mkdir(exist_ok=True)
    return out, subprocess.Popen(
        [_build.nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
         str(out), str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)


def finish(out, proc, what):
    """The library `start` is building, once nvcc has ended; nvcc's output
    and an exit on failure."""
    text, _ = proc.communicate()
    if proc.returncode:
        raise SystemExit(f"nvcc failed for {what}:\n{text}")
    return ctypes.CDLL(str(out))


def edited(_build, source, variants, prefix, bind):
    """[(what, library)] of each (what, [(old, new)]) in `variants`: the
    csrc/ file `source` with every `old` text, which must be in it once,
    replaced by its `new`, built into build/<prefix>_<n>.so and bound by
    `bind` (the wrapper module's ctypes signatures)."""
    src = (_build.CSRC / source).read_text()
    jobs = []
    for i, (what, edits) in enumerate(variants):
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise SystemExit(f"{old!r} is not in {source} once")
            text = text.replace(old, new)
        cu = _build.CSRC / f"{prefix}_{i}.cu"
        cu.write_text(text)
        jobs.append((what, cu) + start(_build, f"{prefix}_{i}", cu))
    libs = []
    for what, cu, out, proc in jobs:
        try:
            lib = finish(out, proc, what)
        finally:
            cu.unlink()
        bind(lib)
        libs.append((what, lib))
    return libs


@contextlib.contextmanager
def bound(_build, name, lib):
    """The wrappers of library `name` call `lib` inside the block."""
    saved = _build._libs.get(name)
    _build._libs[name] = lib
    try:
        yield
    finally:
        if saved is None:
            _build._libs.pop(name, None)
        else:
            _build._libs[name] = saved
