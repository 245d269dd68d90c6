"""What the split tools share: a kernel's source beside copies of it with one
part cut out (`Split`), each built by its own nvcc process, all at once, and
`time_ms`, a mean device time behind a spin kernel.

A tool knows each version of its source by its marks: `layouts` maps a
version's name to {"cuts": {variant: [(file, old text, new text), ...]},
...}. A version is recognised when every mark of its cuts is found; a cut
replaces every occurrence of its old text. The variants named "no ..." cut
one part each, and "all cut" applies them all at once.
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
CSRC = ROOT / "tpu_audio_torch" / "csrc"
SPIN_CYCLES = 50_000_000  # ~25 ms at the H100's clock: covers queuing a timed loop


class Split:
    """The versions of one source file `src` that tool `tool` knows, built
    into `build/<tool>/`."""

    def __init__(self, tool: str, src: str, layouts: dict):
        self.tool, self.src, self.layouts = tool, src, layouts
        self.out = ROOT / "build" / tool

    def layout(self, sources: dict) -> str:
        """The name of the version whose marks all match `sources` (file →
        text)."""
        for name, spec in self.layouts.items():
            if all(old in sources.get(f, "")
                   for edits in spec["cuts"].values() for f, old, _ in edits):
                return name
        raise RuntimeError(f"{self.tool}: the sources match no known version's marks")

    def variants(self, sources: dict) -> dict:
        """The sources and the cut copies (file → text), by variant name."""
        cuts = self.layouts[self.layout(sources)]["cuts"]

        def apply(edits) -> dict:
            out = dict(sources)
            for f, old, new in edits:
                out[f] = out[f].replace(old, new)
            return out

        out = {"kernel": sources}
        for name, edits in cuts.items():
            out[name] = apply(edits)
        out["all cut"] = apply([e for name, edits in cuts.items() if name.startswith("no ")
                                for e in edits])
        return out

    def read_sources(self, csrc: Path) -> dict:
        """`src` and the headers of `csrc`, and the repository's headers that
        `csrc` lacks (a kept copy of the source alone)."""
        files = {p.name: p.read_text() for p in sorted(csrc.glob("*.cu*"))
                 if p.suffix == ".cuh" or p.name == self.src}
        for p in sorted(CSRC.glob("*.cuh")):
            files.setdefault(p.name, p.read_text())
        return files

    def build(self, versions: dict) -> dict:
        """One nvcc process a key of `versions` ((version, variant) → files),
        all at once; prints the kernels' ptxas register and spill lines;
        returns the loaded libraries by key."""
        from tpu_audio_torch.ops.kernels import _build

        procs = {}
        for i, (key, files) in enumerate(versions.items()):
            d = self.out / f"v{i}"
            shutil.rmtree(d, ignore_errors=True)
            d.mkdir(parents=True)
            for f, text in files.items():
                (d / f).write_text(text)
            cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(d / "k.so"),
                   str(d / self.src)]
            procs[key] = (d, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                              stderr=subprocess.STDOUT, text=True))
        libs = {}
        for key, (d, proc) in procs.items():
            log = proc.communicate()[0]
            if proc.returncode:
                raise RuntimeError(f"{self.tool}: nvcc failed for {key}:\n{log[-4000:]}")
            if not key[1].startswith("no ") and key[1] not in ("launch alone", "all cut"):
                for line in log.splitlines():
                    if "registers" in line or "spill" in line:
                        print(f"  ptxas {key[0]} {key[1]}: {line.strip()}", flush=True)
            libs[key] = ctypes.CDLL(str(d / "k.so"))
        return libs


def time_ms(fn, iters: int) -> float:
    """Mean device time of fn() behind a spin kernel, after one warm-up."""
    fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters
