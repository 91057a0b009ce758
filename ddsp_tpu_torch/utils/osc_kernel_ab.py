"""Race the oscillator kernels K5, K1, K7, K6 and S2 of two checkouts.

    python -m ddsp_tpu_torch.utils.osc_kernel_ab [--parent=DIR] [--iters=100]
        [--kernels=forward,banked] [--sass=DIR] [--out=FILE.json]

Builds ``csrc/osc_hop_slots.cu`` (K5), ``csrc/osc_frames.cu`` (K1),
``csrc/osc_cheb.cu`` (K7) and ``csrc/osc_banked_bwd.cu`` (K6, S2) of this
package and, given ``--parent``, of the checkout at DIR (into DIR's own
``ddsp_tpu_torch/_build``), and calls each library's C entry on the same
seeded card tensors.  ``--kernels`` picks the groups: ``forward`` (K5, K1,
K7) and ``banked`` (K6, S2); both by default.

* ``timed``: K5 at 256, 1024 and 2048 serving slots (hop 512, H=180) on
  both fills, K5 over the 2,752 frame rows of the training shape (B=16,
  T=172; rows copied from ``amps_pad`` once, outside the timing), K1 on
  the exact, rotation and Chebyshev (resync 8 tiles) fills at that shape,
  and K7 at resync 16, 32, 64 and 180 there.  Each is timed with CUDA
  events over ``iters`` calls from Python (``ms``) and over ``iters``
  calls replayed from one CUDA graph (``graph_ms``), in the order
  parent, change, change, parent; with ``max_abs_diff`` between the two
  checkouts' outputs (0: bit-equal) and ``bound_ms``, the larger of 7.5
  FLOP a (sample, harmonic) point at 67 TFLOP/s fp32 and the bytes moved
  at 3.35 TB/s (H100 SXM, 700 W): ``utils/roofline``'s bound of the kernel;
* ``bits``: the same comparison, untimed, at awkward shapes: K5 with
  N = 1, 3 and 257, hops of 128 and 200, H of 1, 7 and 301, h_start up to
  2048 - H; K7 at hops 200 (three window sums) and 512 (two), resync 1, 7,
  32 and above H, H = 7 and 40;
* ``samples``: this package's K5 at each samples-a-thread choice q and
  block size (its ``osc_hop_slots_shape``; ``osc_hop_slots`` takes 2 and
  128) at the timed K5 shapes, in a graph;
* ``banked``: K6 at the training shape on both bank dtypes, the kernel
  alone and with its overlap-add (this package's one-launch
  ``osc_overlap_add``; the parent's own plain ``overlap_add_windows``
  where it has no ``osc_banked_bwd_shape``, as its wrapper ran), and S2,
  raced as above with ``bound_ms`` roofline's (the fill's 7.5 FLOP a
  point binds); untimed at awkward shapes (hops 128, 200 and 512, H of 1,
  7, 40, 180 and 301, h_start up to 2048 - H, both bank dtypes): S2's
  outputs against the parent's (``max_abs_diff``, 0: bit-equal) and K6's
  gradients against the parent's and the plain version's (dB, and
  ``bit_equal`` reruns); and this package's K6 at 1, 2, 4 and 8 warps a
  frame (``osc_banked_bwd_shape``), in a graph;
* given ``--sass``, the SASS of this package's three libraries
  (``cuobjdump``) written there, and for each kernel every loop (a
  backward branch): its address range and instruction count.

Without ``--parent`` the change alone is timed.  Needs a CUDA device.
Prints one JSON object a line and, given ``--out``, writes them all to
that file as one JSON list.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ddsp_tpu_torch.ops.cuda import build, osc_banked_bwd, osc_frames
from ddsp_tpu_torch.ops.interp import hop_weights_on
from ddsp_tpu_torch.utils import roofline
from ddsp_tpu_torch.utils.osc_sweep import operands, snr_db
from ddsp_tpu_torch.utils.profiling import graph_ms, microbench

SLOTS = (256, 1024, 2048)
FRAMES = (16, 172, 512, 180)  # B, T, hop, H: the training shape
RESYNCS = (16, 32, 64, 180)
SHAPES = ((1, 128), (2, 128), (4, 128), (1, 64), (2, 64), (4, 64))  # (q, max threads)
FILLS = {"exact": 0, "rot": 1}  # K5's; K1 also takes "cheb8"
FRAME_FILLS = {"exact": 0, "rot": 1, "cheb8": 2}
WHOLE_BANK = 1 << 30
_P, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {
    "osc_hop_slots": {"osc_hop_slots": [_P] * 7 + [_I] * 5 + [_P]},
    "osc_frames": {"osc_frames_fwd": [_P] * 5 + [_I] * 9 + [_P]},
    "osc_cheb": {"osc_cheb_fwd": [_P] * 5 + [_I] * 5 + [_P]},
    "osc_banked_bwd": {"osc_banked_bwd": [_P] * 8 + [_I] * 6 + [_P]},
}
OPTIONAL = {  # this package's K5 and K6 entries; S2 with its `sink` since K6 has a shape entry
    "osc_hop_slots": {"osc_hop_slots_shape": [_P] * 7 + [_I] * 7 + [_P]},
    "osc_banked_bwd": {"osc_banked_bwd_shape": [_P] * 8 + [_I] * 7 + [_P]},
}
FILL_ONLY = {False: [_P] * 5 + [_I] * 4 + [_P], True: [_P] * 5 + [_I] * 4 + [_P, _P]}
GROUPS = {"forward": ("osc_hop_slots", "osc_frames", "osc_cheb"), "banked": ("osc_banked_bwd",)}
WARPS = (1, 2, 4, 8)
BANKED_BITS = ((2, 3, 128, 1, 0), (2, 3, 200, 7, 5), (2, 4, 128, 40, 8), (1, 2, 200, 301, 1747),
               (2, 3, 512, 180, 0), (1, 3, 200, 40, 2008))  # B, T, hop, H, h_start


class Kernels:
    """One checkout's libraries (``names``, keys of SIGNATURES), called on
    the current stream."""

    def __init__(self, root: Optional[Path] = None, names=tuple(SIGNATURES)):
        csrc = build.CSRC if root is None else root / "ddsp_tpu_torch" / "csrc"
        out = build.BUILD_DIR if root is None else root / "ddsp_tpu_torch" / "_build"
        self.paths = {name: build.build(name, csrc, out) for name in names}
        self.libs = {}
        for name in names:
            lib = ctypes.CDLL(str(self.paths[name]))
            sigs = {**SIGNATURES[name], **OPTIONAL.get(name, {})}
            if name == "osc_banked_bwd":
                self.shaped = hasattr(lib, "osc_banked_bwd_shape")
                sigs["osc_fill_only"] = FILL_ONLY[self.shaped]
            for fn, argtypes in sigs.items():
                if hasattr(lib, fn):
                    getattr(lib, fn).argtypes = argtypes
                    getattr(lib, fn).restype = _I
            self.libs[name] = lib

    @staticmethod
    def _check(rc: int, what: str) -> None:
        if rc != 0:
            raise RuntimeError(f"{what} launch failed: CUDA error {rc}")

    def hop_slots(self, phase, a_l, a_m, a_r, loud, w, fill="rot", h_start=0, shape=None):
        n, hop = phase.shape
        out = torch.empty_like(phase)
        args = [t.data_ptr() for t in (phase, a_l, a_m, a_r, loud, w, out)]
        args += [n, hop, a_l.shape[-1], h_start, FILLS[fill]]
        lib = self.libs["osc_hop_slots"]
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.osc_hop_slots(*args, stream) if shape is None else lib.osc_hop_slots_shape(
            *args, *shape, stream)
        self._check(rc, "osc_hop_slots")
        return out

    def frames_fwd(self, phase, amps, loud, fill="rot"):
        b, t, hop = phase.shape
        w = hop_weights_on(hop, phase.device)
        out = torch.empty((b, t * hop), dtype=torch.float32, device=phase.device)
        rc = self.libs["osc_frames"].osc_frames_fwd(
            phase.data_ptr(), amps.data_ptr(), loud.data_ptr(), w.data_ptr(), out.data_ptr(),
            b, t, hop, amps.shape[-1], 0, FRAME_FILLS[fill], 0, 8, WHOLE_BANK,
            torch.cuda.current_stream().cuda_stream)
        self._check(rc, "osc_frames_fwd")
        return out

    def cheb(self, phase, amps, loud, resync):
        b, t, hop = phase.shape
        w = hop_weights_on(hop, phase.device)
        out = torch.empty((b, t * hop), dtype=torch.float32, device=phase.device)
        rc = self.libs["osc_cheb"].osc_cheb_fwd(
            phase.data_ptr(), amps.data_ptr(), loud.data_ptr(), w.data_ptr(), out.data_ptr(),
            b, t, hop, amps.shape[-1], resync, torch.cuda.current_stream().cuda_stream)
        self._check(rc, "osc_cheb_fwd")
        return out


    def banked_bwd(self, g, phase, amps, loud, h_start=0, bank_dtype="float32", warps=None):
        """K6 alone: (dphase, da_win (B, T, 3, H), dl_win (B, T, 3))."""
        b, t, hop = phase.shape
        h = amps.shape[-1]
        w = hop_weights_on(hop, phase.device)
        outs = (torch.empty_like(phase), torch.empty((b, t, 3, h), device=phase.device),
                torch.empty((b, t, 3), device=phase.device))
        args = [x.data_ptr() for x in (g, phase, amps, loud, w, *outs)]
        args += [b, t, hop, h, h_start, int(bank_dtype == "bfloat16")]
        lib = self.libs["osc_banked_bwd"]
        stream = torch.cuda.current_stream().cuda_stream
        rc = (lib.osc_banked_bwd(*args, stream) if warps is None
              else lib.osc_banked_bwd_shape(*args, warps, stream))
        self._check(rc, "osc_banked_bwd")
        return outs

    def banked_bwd_full(self, g, phase, amps, loud, h_start=0, bank_dtype="float32"):
        """K6 with the overlap-add its checkout's wrapper runs: (dphase,
        d amps_pad, d loud_pad)."""
        dphase, da_win, dl_win = self.banked_bwd(g, phase, amps, loud, h_start, bank_dtype)
        add = osc_frames.osc_overlap_add if self.shaped else osc_frames.overlap_add_windows
        return (dphase, *add(da_win, dl_win, phase.shape[1]))

    def fill_only(self, phase, amps):
        """S2: (dphase, da_win (B, T, 3, H), dl_win (B, T, 3))."""
        b, t, hop = phase.shape
        h = amps.shape[-1]
        outs = (torch.empty_like(phase), torch.empty((b, t, 3, h), device=phase.device),
                torch.empty((b, t, 3), device=phase.device))
        sink = [None] if self.shaped else []
        rc = self.libs["osc_banked_bwd"].osc_fill_only(
            phase.data_ptr(), amps.data_ptr(), *[x.data_ptr() for x in outs], b, t, hop, h,
            *sink, torch.cuda.current_stream().cuda_stream)
        self._check(rc, "osc_fill_only")
        return outs


def slot_operands(n: int, hop: int, h: int, device, seed: int):
    """chip_smoke.py's K5 operands: phase, three amplitude rows (each
    summing to 1), (N, 3) loudness, the (hop, 3) weights."""
    rng = np.random.default_rng(seed)
    amps = rng.uniform(0.0, 1.0, (3, n, h))
    amps /= amps.sum(-1, keepdims=True)
    arrays = [rng.uniform(0.0, 1.0, (n, hop)), *amps, rng.uniform(0.0, 1.0, (n, 3))]
    tensors = [torch.tensor(a, dtype=torch.float32, device=device) for a in arrays]
    return tensors + [hop_weights_on(hop, device)]


def frame_rows(phase, amps, loud):
    """K5's operands for every frame of a batch as its own row."""
    b, t, hop = phase.shape
    rows = lambda x: x.reshape(b * t, -1).contiguous()  # noqa: E731
    lw = torch.stack([loud[:, :-2], loud[:, 1:-1], loud[:, 2:]], -1)
    return [rows(phase), rows(amps[:, :-2]), rows(amps[:, 1:-1]), rows(amps[:, 2:]),
            lw.reshape(b * t, 3).contiguous(), hop_weights_on(hop, phase.device)]


def _tensors(x):
    return list(x) if isinstance(x, (tuple, list)) else [x]


def max_abs_diff(a, b) -> float:
    """The largest |a - b| over a tensor or over a tuple of them."""
    return max(float((x - y).abs().max()) for x, y in zip(_tensors(a), _tensors(b)))


def race(case: str, fns: Dict[str, Callable], iters: int, bound) -> dict:
    """Outputs compared and times taken of one case (``fns``: checkout ->
    call), each checkout timed twice, in the order parent, change, change,
    parent."""
    outs = {k: fn() for k, fn in fns.items()}
    torch.cuda.synchronize()
    row = dict(case=case, finite=all(bool(torch.isfinite(x).all())
                                     for o in outs.values() for x in _tensors(o)))
    if "parent" in outs:
        row["max_abs_diff"] = max_abs_diff(outs["parent"], outs["change"])
    del outs
    order = ("parent", "change", "change", "parent") if "parent" in fns else ("change",) * 2
    for name in order:
        row.setdefault(f"{name}_ms", []).append(microbench(fns[name], (), iters, 3)["ms"])
    for name in order:
        row.setdefault(f"{name}_graph_ms", []).append(graph_ms(fns[name], iters))
    row["bound_ms"], row["bound_by"] = bound
    return row


def timed_cases(kernels: Dict[str, Kernels], device, iters: int) -> List[dict]:
    def each(call):  # {checkout: its call}
        return {name: (lambda k=k: call(k)) for name, k in kernels.items()}

    rows = []
    for n in SLOTS:
        ops = slot_operands(n, 512, 180, device, seed=n)
        for fill in FILLS:
            rows.append(race(f"K5 N={n} {fill}", each(lambda k, f=fill: k.hop_slots(*ops, fill=f)),
                             iters, roofline.kernel_bound_ms(n, 512, 180)))
    b, t, hop, h = FRAMES
    phase, amps, loud, _ = operands(b, t, hop, h, device)
    ops = frame_rows(phase, amps, loud)
    rows.append(race("K5 rows B=16 T=172 rot", each(lambda k: k.hop_slots(*ops, fill="rot")),
                     iters, roofline.variant_bound_ms("osc_hop_slots", b, t, hop, h)))
    for fill in FRAME_FILLS:
        rows.append(race(f"K1 B=16 T=172 {fill}",
                         each(lambda k, f=fill: k.frames_fwd(phase, amps, loud, f)),
                         iters, roofline.variant_bound_ms("osc_frames_fwd", b, t, hop, h)))
    for r in RESYNCS:
        rows.append(race(f"K7 B=16 T=172 r{r}", each(lambda k, r=r: k.cheb(phase, amps, loud, r)),
                         iters, roofline.variant_bound_ms("osc_cheb_fwd", b, t, hop, h)))
    return rows


def bit_cases(kernels: Dict[str, Kernels], device) -> List[dict]:
    """Parent against change, untimed, at awkward shapes."""
    rows = []
    for n, hop, h, h_start in ((1, 128, 1, 0), (3, 200, 7, 5), (257, 512, 180, 0),
                               (3, 128, 301, 2048 - 301), (257, 200, 40, 2048 - 40)):
        ops = slot_operands(n, hop, h, device, seed=n + hop + h)
        for fill in FILLS:
            outs = [kk.hop_slots(*ops, fill=fill, h_start=h_start) for kk in kernels.values()]
            rows.append(dict(case=f"K5 N={n} hop={hop} H={h} h_start={h_start} {fill}",
                             max_abs_diff=max_abs_diff(*outs)))
    for hop in (200, 512):
        for h in (7, 40):
            phase, amps, loud, _ = operands(2, 5, hop, h, device, seed=hop + h)
            for r in (1, 7, 32, h + 1):
                outs = [kk.cheb(phase, amps, loud, r) for kk in kernels.values()]
                rows.append(dict(case=f"K7 B=2 T=5 hop={hop} H={h} r{r}",
                                 max_abs_diff=max_abs_diff(*outs)))
    return rows


def banked_timed_cases(kernels: Dict[str, Kernels], device, iters: int) -> List[dict]:
    """K6 (both bank dtypes, alone and with its overlap-add) and S2 at the
    training shape, raced."""
    b, t, hop, h = FRAMES
    phase, amps, loud, g = operands(b, t, hop, h, device)
    k6_bound = roofline.variant_bound_ms("osc_banked_bwd", b, t, hop, h)
    rows = []
    for dtype in ("float32", "bfloat16"):
        rows.append(race(f"K6 B=16 T=172 {dtype} alone",
                         {n: (lambda k=k, d=dtype: k.banked_bwd(g, phase, amps, loud, 0, d))
                          for n, k in kernels.items()},
                         iters, k6_bound))
        rows.append(race(f"K6 B=16 T=172 {dtype} with its overlap-add",
                         {n: (lambda k=k, d=dtype: k.banked_bwd_full(g, phase, amps, loud, 0, d))
                          for n, k in kernels.items()},
                         iters, k6_bound))
    rows.append(race("S2 B=16 T=172", {n: (lambda k=k: k.fill_only(phase, amps))
                                       for n, k in kernels.items()},
                     iters, roofline.variant_bound_ms("osc_fill_only", b, t, hop, h)))
    return rows


def banked_bit_cases(kernels: Dict[str, Kernels], device) -> List[dict]:
    """S2 against the parent (0: bit-equal) and K6's gradients against the
    parent's and the plain version's, untimed, at awkward shapes."""
    rows = []
    for b, t, hop, h, h_start in BANKED_BITS:
        phase, amps, loud, g = operands(b, t, hop, h, device, seed=b + t + hop + h)
        shape = f"B={b} T={t} hop={hop} H={h}"
        fills = [kk.fill_only(phase, amps) for kk in kernels.values()]
        rows.append(dict(case=f"S2 {shape}", max_abs_diff=max_abs_diff(*fills)))
        for dtype in ("float32", "bfloat16"):
            got = {n: kk.banked_bwd_full(g, phase, amps, loud, h_start, dtype)
                   for n, kk in kernels.items()}
            again = kernels["change"].banked_bwd_full(g, phase, amps, loud, h_start, dtype)
            plain = osc_banked_bwd.banked_bwd_plain(g, phase, amps, loud, h_start, dtype)
            row = dict(case=f"K6 {shape} h_start={h_start} {dtype}",
                       bit_equal=all(bool(torch.equal(x, y)) for x, y in zip(got["change"], again)),
                       db_plain=[snr_db(p, x) for p, x in zip(plain, got["change"])])
            if "parent" in got:
                row["db_parent"] = [snr_db(p, x) for p, x in zip(got["parent"], got["change"])]
                row["parent_db_plain"] = [snr_db(p, x) for p, x in zip(plain, got["parent"])]
            rows.append(row)
    return rows


def warp_cases(change: Kernels, device, iters: int) -> List[dict]:
    """This package's K6 at each number of warps a frame, in a graph."""
    b, t, hop, h = FRAMES
    phase, amps, loud, g = operands(b, t, hop, h, device)
    ref = change.banked_bwd(g, phase, amps, loud)
    row = dict(case="K6 B=16 T=172 float32 warps a frame")
    for warps in WARPS:
        fn = lambda n=warps: change.banked_bwd(g, phase, amps, loud, warps=n)  # noqa: E731
        row[f"w{warps}_max_abs_diff"] = max_abs_diff(ref, fn())
        row[f"w{warps}_graph_ms"] = [graph_ms(fn, iters), graph_ms(fn, iters)]
    return [row]


def sample_cases(change: Kernels, device, iters: int) -> List[dict]:
    """K5 at each samples-a-thread choice and block size, in a graph."""
    b, t, hop, h = FRAMES
    shapes = [(f"N={n}", slot_operands(n, 512, 180, device, seed=n)) for n in SLOTS]
    shapes.append(("rows B=16 T=172", frame_rows(*operands(b, t, hop, h, device)[:3])))
    rows = []
    for label, ops in shapes:
        for fill in FILLS:
            ref = change.hop_slots(*ops, fill=fill)
            row = dict(case=f"K5 {label} {fill}")
            for q, threads in SHAPES:
                fn = lambda s=(q, threads): change.hop_slots(*ops, fill=fill, shape=s)  # noqa: E731
                key = f"q{q}_t{threads}"
                row[f"{key}_max_abs_diff"] = max_abs_diff(ref, fn())
                row[f"{key}_graph_ms"] = [graph_ms(fn, iters), graph_ms(fn, iters)]
            rows.append(row)
    return rows


def sass_loops(sass: str) -> Dict[str, List[dict]]:
    """{kernel: [loop, ...]} of a ``cuobjdump -sass`` listing: each backward
    branch's body, its first and last address and its instruction count."""
    out = {}
    for section in sass.split("Function : ")[1:]:
        name = section.split("\n", 1)[0].strip()
        instr = [(int(m.group(1), 16), m.group(2))
                 for m in re.finditer(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", section)]
        loops = []
        for addr, text in instr:
            m = re.search(r"\bBRA\s+(0x[0-9a-f]+)", text)
            if m and int(m.group(1), 16) <= addr:
                start = int(m.group(1), 16)
                loops.append(dict(start=hex(start), end=hex(addr),
                                  instructions=sum(start <= a <= addr for a, _ in instr)))
        out[name] = loops
    return out


def dump_sass(change: Kernels, out_dir: Path) -> List[dict]:
    from torch.utils.cpp_extension import CUDA_HOME

    out_dir.mkdir(parents=True, exist_ok=True)
    rows = []
    for name, path in change.paths.items():
        sass = subprocess.run([os.path.join(CUDA_HOME, "bin", "cuobjdump"), "-sass", str(path)],
                              capture_output=True, text=True, check=True).stdout
        (out_dir / f"{name}.sass").write_text(sass)
        for kernel, loops in sass_loops(sass).items():
            rows.append(dict(library=name, kernel=kernel, loops=loops))
    return rows


def main(argv=None) -> List[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, help="root of another checkout to race")
    ap.add_argument("--iters", type=int, default=100)
    ap.add_argument("--kernels", default="forward,banked",
                    help="comma-separated groups: forward (K5, K1, K7), banked (K6, S2)")
    ap.add_argument("--sass", type=Path, help="directory for the SASS listings")
    ap.add_argument("--out", type=Path)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("osc_kernel_ab needs a CUDA device")
    device = torch.device("cuda", 0)
    groups = args.kernels.split(",")
    if not groups or any(grp not in GROUPS for grp in groups):
        raise ValueError(f"--kernels takes groups of {sorted(GROUPS)}, got {args.kernels!r}")
    names = tuple(n for grp in groups for n in GROUPS[grp])
    kernels = {"change": Kernels(names=names)}
    if args.parent is not None:
        kernels = {"parent": Kernels(args.parent.resolve(), names), **kernels}
    rows = [dict(device=torch.cuda.get_device_name(device),
                 libraries={k: {n: str(p) for n, p in v.paths.items()}
                            for k, v in kernels.items()})]
    if "forward" in groups:
        if args.parent is not None:
            rows += bit_cases(kernels, device)
        rows += timed_cases(kernels, device, args.iters)
        rows += sample_cases(kernels["change"], device, args.iters)
    if "banked" in groups:
        rows += banked_bit_cases(kernels, device)
        rows += banked_timed_cases(kernels, device, args.iters)
        rows += warp_cases(kernels["change"], device, args.iters)
    if args.sass is not None:
        rows += dump_sass(kernels["change"], args.sass)
    for row in rows:
        print(json.dumps(row), flush=True)
    if args.out is not None:
        args.out.write_text(json.dumps(rows, indent=1))
    return rows


if __name__ == "__main__":
    main()
