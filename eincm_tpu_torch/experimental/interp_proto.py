"""Coarse-theta interpolation in the dense layout (kernel 9), and its bench.

    python3 -m eincm_tpu_torch.experimental.interp_proto

Replaces the TPU kernel of scripts/interp_kernel_proto.py (`_fwd_kernel`
through `interp_pallas`) with the CUDA kernel of `csrc/interp_dense.cu`,
whose product runs on the tensor cores (warp-level `mma.sync`), and keeps
its plain PyTorch version beside it.

`interp_dense` computes the production interp's function
(`ops/interp.py:interp_theta_at_events`, kernel 1) from full weight rows:
per event, at the rounded coordinates, the dense triangle weights uy (hp)
and vx (wp) of the two axes (h and w padded to a multiple of 8), and
out[c] = sum_j vx[j] sum_k thT[c wp + j, k] uy[k] with thT the transposed,
zero-padded theta. Modes, as the prototype's:

- `highest`: f32 weights and theta; the kernel's product is 3xTF32
  (lo.hi + hi.lo + hi.hi, hi = tf32(x), lo = tf32(x - hi)), within ~2^-21
  of f32 per term, so it agrees with kernel 1 within 1e-6 x max |out|, not
  bitwise (the TPU's `Precision.HIGHEST` was not bitwise f32 either);
- `dot3`: the inner product as three bf16-split products (hi.hi + hi.lo +
  lo.hi, lo = x - hi), the prototype's `_dot3`; the kernel carries each lo
  as two bf16 parts, so its products are as exact as the plain version's;
- `bf16`: weights and theta rounded to bf16, one bf16 product, sums in f32;
- `nonorm`: as `highest`, without dividing the weights by their sum.

The prototype's `chunk` argument only tiled the TPU's lanes and is
dropped. Dispatch: CPU tensors take the plain version; CUDA tensors launch
the kernel, and anything it does not take raises.

`main()` ports the prototype's bench: at 1.5M events on a 480x640 sensor
and a 16x16 theta drawn N(0, 4) (numpy seed 0), it holds `highest` and
`dot3` against kernel 1 and times them, and `bf16`, beside kernel 1 and the
plain forward+backward, with CUDA events (`utils/profiling.cuda_ms`). It
prints the card and one JSON line, and exits 2 without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Tuple

import numpy as np
import torch

from eincm_tpu_torch.ops import _build
from eincm_tpu_torch.ops._build import KERNELS, check_cuda_f32
from eincm_tpu_torch.ops.interp import (
    _axis_weights,
    _scales,
    interp_fwd_cuda,
    interp_theta_at_events,
    interp_theta_at_events_plain,
)
from eincm_tpu_torch.utils.profiling import card, cuda_ms

MODES = ("highest", "dot3", "bf16", "nonorm")


def _pad8(n: int) -> int:
    return max(8, -(-n // 8) * 8)


def _check_mode(mode: str) -> int:
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} not in {MODES}")
    return MODES.index(mode)


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(x.dtype)


def interp_dense_plain(
    theta: torch.Tensor,
    xs: torch.Tensor,
    ys: torch.Tensor,
    sensor_size: Tuple[int, int],
    mode: str = "highest",
) -> torch.Tensor:
    """The plain version: dense weight rows and one (E, hp) x (hp, 2 wp)
    matrix product (three under `dot3`). Returns (E, 2)."""
    _check_mode(mode)
    h, w, _ = theta.shape
    H, W = sensor_size
    hp, wp = _pad8(h), _pad8(w)
    norm = mode != "nonorm"
    dtype = theta.dtype
    uy = _axis_weights(ys.to(dtype), h, hp, float(h) / H, norm)
    vx = _axis_weights(xs.to(dtype), w, wp, float(w) / W, norm)
    thT = torch.zeros((2 * wp, hp), dtype=dtype, device=theta.device)
    thT[:w, :h] = theta[..., 0].T
    thT[wp : wp + w, :h] = theta[..., 1].T
    if mode == "dot3":
        uh, th = _bf16(uy), _bf16(thT)
        ul, tl = uy - uh, thT - th
        m = (uh @ th.T + ul @ th.T) + uh @ tl.T  # (E, 2 wp)
    else:
        if mode == "bf16":
            uy, vx, thT = _bf16(uy), _bf16(vx), _bf16(thT)
        m = uy @ thT.T
    return torch.stack(
        [(m[:, :wp] * vx).sum(1), (m[:, wp:] * vx).sum(1)], dim=-1
    )


def interp_dense_cuda(theta, xs, ys, sensor_size, mode: str = "highest") -> torch.Tensor:
    """Launch kernel 9: (h, w, 2) theta, (E,) coordinates -> (E, 2)."""
    code = _check_mode(mode)
    h, w, _ = theta.shape
    e = xs.shape[0]
    check_cuda_f32("interp_dense", (theta, xs, ys), ((h, w, 2), (e,), (e,)))
    sy, sx = _scales(h, w, sensor_size)
    out = torch.empty((e, 2), dtype=torch.float32, device=theta.device)
    if e:
        with torch.cuda.device(theta.device):
            KERNELS["interp_dense"](
                theta.data_ptr(), xs.data_ptr(), ys.data_ptr(), out.data_ptr(),
                e, h, w, _pad8(h), _pad8(w), sy, sx, code,
                torch.cuda.current_stream().cuda_stream,
            )
    return out


def interp_dense(
    theta: torch.Tensor,
    xs: torch.Tensor,
    ys: torch.Tensor,
    sensor_size: Tuple[int, int],
    mode: str = "highest",
) -> torch.Tensor:
    """Per-event velocity from the coarse (h, w, 2) theta -> (E, 2), in the
    dense layout (module docstring). Forward only."""
    if all(t.device.type == "cpu" for t in (theta, xs, ys)):
        return interp_dense_plain(theta, xs, ys, sensor_size, mode)
    return interp_dense_cuda(theta, xs, ys, sensor_size, mode)


# ---- the bench -------------------------------------------------------------

SENSOR = (480, 640)
N_EVENTS = 1_500_000


def make_inputs(device):
    """The prototype's inputs: (theta, xs, ys) from numpy seed 0."""
    H, W = SENSOR
    rng = np.random.default_rng(0)
    xs = rng.uniform(0, W - 1, N_EVENTS).astype(np.float32)
    ys = rng.uniform(0, H - 1, N_EVENTS).astype(np.float32)
    theta = rng.normal(0, 4, (16, 16, 2)).astype(np.float32)
    t = lambda a: torch.as_tensor(a, device=device)
    return t(theta), t(xs), t(ys)


def compare_with_kernel1(theta, xs, ys) -> dict:
    """Kernel 9 in the prototype's two measured modes against kernel 1
    (the production interp) on CUDA tensors: max abs and relative error,
    and whether they are equal (not expected: `highest` is 3xTF32)."""
    ref = interp_fwd_cuda(theta, xs, ys, SENSOR)
    res = {}
    for mode in ("highest", "dot3"):
        out = interp_dense(theta, xs, ys, SENSOR, mode)
        err = float((out - ref).abs().max())
        rel = err / float(ref.abs().max())
        res[f"{mode}_max_abs_err_vs_kernel1"] = err
        res[f"{mode}_rel_err_vs_kernel1"] = rel
        res[f"{mode}_equal_to_kernel1"] = bool(torch.equal(out, ref))
        print(f"mode={mode}: max abs err vs kernel 1 {err:.3e} rel {rel:.3e}, "
              f"equal {res[f'{mode}_equal_to_kernel1']}")
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=None, help="also write the JSON here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("interp_proto: needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)
    name = card()
    print(f"{name}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    _build.build_all()
    theta, xs, ys = make_inputs(device)
    res = {"card": name, "n_events": N_EVENTS, "sensor": list(SENSOR), "grid": [16, 16],
           **compare_with_kernel1(theta, xs, ys)}

    th = theta.clone().requires_grad_(True)

    def fwd_bwd(interp):
        (g,) = torch.autograd.grad(interp(th, xs, ys, SENSOR).sum(), th)
        return g

    res["ms"] = {
        "kernel1_interp_fwd": cuda_ms(lambda: interp_fwd_cuda(theta, xs, ys, SENSOR)),
        "kernel9_highest": cuda_ms(lambda: interp_dense_cuda(theta, xs, ys, SENSOR, "highest")),
        "kernel9_dot3": cuda_ms(lambda: interp_dense_cuda(theta, xs, ys, SENSOR, "dot3")),
        "kernel9_bf16": cuda_ms(lambda: interp_dense_cuda(theta, xs, ys, SENSOR, "bf16")),
        "plain_fwd": cuda_ms(lambda: interp_theta_at_events_plain(theta, xs, ys, SENSOR)),
        "plain_fwd_bwd": cuda_ms(lambda: fwd_bwd(interp_theta_at_events_plain)),
        "kernels_fwd_bwd": cuda_ms(lambda: fwd_bwd(interp_theta_at_events)),
    }
    for k, v in res["ms"].items():
        print(f"{k}: {v:.4f} ms")
    line = json.dumps(res)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")
    print(name)
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
