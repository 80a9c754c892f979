"""Experiment plotting: per-window end-result figures, metric sequences, video.

Port of eincm_tpu/experiments/plotters.py (reference: `EINCMExperimentPlotter`,
src/experiments/e00/plotters.py:26-974): polarity event frames, IWE
before/after warping, edge/image/flow blends, the end-result figure grid, and
FWL/AEE/ANPE sequence charts. Video assembly writes an MJPEG AVI and an
animated GIF via PIL. Matplotlib and PIL are imported by the functions
that draw (the card's machine has neither). The warps and IWEs go through
the port's `warp_events_multi_ref` and `events_to_pdf_frame`, on the
device of the staged window (the splat kernel on a card).
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from eincm_tpu_torch.data.staging import StagedSample
from eincm_tpu_torch.ops.normalize import normalize_to_unit_range
from eincm_tpu_torch.ops.splat import events_to_pdf_frame
from eincm_tpu_torch.ops.warp import warp_events_multi_ref
from eincm_tpu_torch.utils.flow_vis import embed_flow_code_in_img, flow_uv_to_img


def _pyplot():
    """matplotlib.pyplot on the non-interactive Agg backend."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _warp(theta_full, xs, ys, ts, edge_ts):
    """Eval events warped to every reference time under a full-sensor
    theta, on the staged window's device -> (n_refs, E) xs and ys."""
    dev = edge_ts.device
    f32 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32, device=dev)
    with torch.no_grad():
        return warp_events_multi_ref(
            torch.as_tensor(theta_full).to(dev), f32(xs), f32(ys), f32(ts), edge_ts
        )


def _numpy(a) -> np.ndarray:
    """A tensor (on any device) or array as a numpy array."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def construct_event_frame(
    xs, ys, ps, sensor_size, polarity_colors=True
) -> np.ndarray:
    """Accumulate events into an RGB frame, red/blue by polarity
    (reference: plotters.py:174-225)."""
    h, w = sensor_size
    frame = np.full((h, w, 3), 255, np.uint8)
    xs = np.asarray(xs, np.float64)
    ys = np.asarray(ys, np.float64)
    fin = np.isfinite(xs) & np.isfinite(ys)  # drop NaN-padded events
    xi = np.clip(np.round(xs[fin]).astype(int), 0, w - 1)
    yi = np.clip(np.round(ys[fin]).astype(int), 0, h - 1)
    pol = np.asarray(ps, bool)[fin]
    if polarity_colors:
        frame[yi[pol], xi[pol]] = (220, 40, 40)
        frame[yi[~pol], xi[~pol]] = (40, 40, 220)
    else:
        frame[yi, xi] = (0, 0, 0)
    return frame


def _event_mask_np(xs, ys, sensor_size) -> np.ndarray:
    h, w = sensor_size
    xi = np.round(np.asarray(xs, np.float64))
    yi = np.round(np.asarray(ys, np.float64))
    ok = np.isfinite(xi) & np.isfinite(yi)
    ok &= (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
    mask = np.zeros((h, w), bool)
    mask[yi[ok].astype(int), xi[ok].astype(int)] = True
    return mask


def blend_two_imgs(a: np.ndarray, b: np.ndarray, alpha: float) -> np.ndarray:
    """cv.addWeighted equivalent (reference: img_utils.py:107-128)."""
    out = a.astype(np.float64) * alpha + b.astype(np.float64) * (1 - alpha)
    return np.clip(out, 0, 255).astype(np.uint8)


def _whitened_image(img: np.ndarray) -> np.ndarray:
    """Grayscale image -> whitened 3-channel uint8 backdrop
    (reference: plotters.py:714-718)."""
    a = np.asarray(img, np.float64)
    a = (a - a.min()) / (a.max() - a.min() + 1e-12) * 255
    img3 = np.stack([a] * 3, axis=-1).astype(np.uint8)
    return blend_two_imgs(img3, np.full_like(img3, 255), 0.5)


def overlay_events_on_image(
    xs, ys, img3: np.ndarray, event_color=(213, 0, 50)
) -> np.ndarray:
    """Paint event pixels onto a 3-channel image
    (reference: plotters.py overlay_events_on_image)."""
    out = img3.copy()
    mask = _event_mask_np(xs, ys, out.shape[:2])
    out[mask] = np.asarray(event_color, np.uint8)
    return out


def event_flow_image_blend(
    flow: np.ndarray, img3: np.ndarray, mask: np.ndarray
) -> np.ndarray:
    """Flow colors at masked pixels blended over a whitened image
    (reference: plotters.py get_event_flow_and_image_blend)."""
    flow_img = flow_uv_to_img(np.where(mask[..., None], flow, 0.0))
    out = img3.copy()
    out[mask] = flow_img[mask]
    return out


def blend_image_events_and_gt_flow(
    image: np.ndarray,
    xs,
    ys,
    gt_flow: np.ndarray,
    triple_blend: bool = False,
) -> np.ndarray:
    """Red events over the GT-flow color image, blended onto the grayscale
    frame (reference: plotters.py:250-286 `blend_image_events_and_gt_flow`).

    With `triple_blend`, the event/GT composite is additionally alpha-blended
    (0.8) back onto the pure GT-flow image before the final 0.35 image blend —
    the reference's `triple_blend=True` path.
    """
    a = np.asarray(image, np.float64)
    a = (a - a.min()) / (a.max() - a.min() + 1e-12) * 255
    img3 = np.stack([a] * 3, axis=-1).astype(np.uint8)

    gt_flow_img = flow_uv_to_img(np.asarray(gt_flow))

    sensor = img3.shape[:2]
    ev_mask = _event_mask_np(xs, ys, sensor)
    # normalized event counts as the red channel (reference builds a red
    # event frame from the normalized accumulation)
    counts = np.zeros(sensor, np.float64)
    xi = np.round(np.asarray(xs, np.float64))
    yi = np.round(np.asarray(ys, np.float64))
    ok = np.isfinite(xi) & np.isfinite(yi)
    ok &= (xi >= 0) & (xi < sensor[1]) & (yi >= 0) & (yi < sensor[0])
    np.add.at(counts, (yi[ok].astype(int), xi[ok].astype(int)), 1.0)
    norm = counts / (counts.max() + 1e-12) * 255
    red_ev = np.zeros_like(img3)
    red_ev[..., 0] = norm.astype(np.uint8)

    evt_gt = np.where(ev_mask[..., None], red_ev, gt_flow_img)
    evt_gt = embed_flow_code_in_img(evt_gt)
    if triple_blend:
        evt_gt = blend_two_imgs(evt_gt, gt_flow_img, 0.8)
    return blend_two_imgs(img3, evt_gt, 0.35)


class EINCMExperimentPlotter:
    def __init__(self, cfg, plot_dir):
        self.cfg = cfg
        self.plot_dir = Path(plot_dir)
        os.makedirs(self.plot_dir, exist_ok=True)
        self.end_result_paths = []

    # --------------------------------------------------------- end results

    def plot_end_results(
        self, idx: int, staged: StagedSample, theta_full
    ) -> Path:
        """The reference's 3x4 end-result figure (plotters.py:648-857):

            GT flow              | zero-warp events     | image t0   | edge t0
            GT-flow+image blend  | events+image overlay | GT event   | scatter
              (before)           |   (before)           |   flow     | (before)
            pred-flow+img blend  | events+image overlay | pred event | scatter
              (after)            |   (after)            |   flow     | (after)
        """
        w = staged.window
        sensor = tuple(self.cfg.dataset.sensor_size)
        ev = staged.eval_events
        xs = np.asarray(ev["x"], np.float64)
        ys = np.asarray(ev["y"], np.float64)
        ts = np.asarray(ev["t"], np.float64)

        plt = _pyplot()
        theta = _numpy(theta_full)
        wx, wy = _warp(theta_full, xs, ys, ts, w.edge_ts)
        lwx, lwy = _numpy(wx[0]).astype(np.float64), _numpy(wy[0]).astype(np.float64)
        # in-array filter of warped events (reference: plotters.py:679-694)
        keep = (
            (np.round(lwx) >= 0) & (np.round(lwx) < sensor[1])
            & (np.round(lwy) >= 0) & (np.round(lwy) < sensor[0])
        )
        xs_k, ys_k = xs[keep], ys[keep]
        lwx, lwy = lwx[keep], lwy[keep]

        img3w = _whitened_image(staged.images[0])
        ev_mask_bef = _event_mask_np(xs_k, ys_k, sensor)
        pred_event_flow = np.where(ev_mask_bef[..., None], theta, 0.0)

        gt = staged.gt_flow
        if gt is not None:
            gt = np.asarray(gt, np.float64)
            gt_valid = (
                np.isfinite(gt[..., 0]) & np.isfinite(gt[..., 1])
                & (np.linalg.norm(gt, axis=-1) > 0)
            )
            gt_event_mask = gt_valid & ev_mask_bef
            gt_event_flow = np.where(gt_event_mask[..., None], gt, 0.0)

        white = np.full((*sensor, 3), 255, np.uint8)

        fig, axs = plt.subplots(3, 4, figsize=(22, 13))
        fig.suptitle(
            f"{self.cfg.dataset.sequence_name} optimization end results "
            f"[idx={idx}]"
        )

        def na(ax):
            ax.annotate(
                "N/A", (0.5, 0.5), xycoords="axes fraction",
                ha="center", va="center", fontsize=50, color="darkgray",
            )

        if gt is not None:
            axs[0, 0].imshow(embed_flow_code_in_img(flow_uv_to_img(gt)))
        else:
            na(axs[0, 0])
        axs[0, 0].set_title("GT Flow")

        axs[0, 1].imshow(overlay_events_on_image(xs_k, ys_k, white))
        axs[0, 1].set_title("Image of Zero-Warped Events")
        axs[0, 2].imshow(staged.images[0], cmap="gray")
        axs[0, 2].set_title("Image at t$_0$")
        im = axs[0, 3].imshow(_numpy(w.edges[0]), cmap="binary")
        fig.colorbar(im, ax=axs[0, 3], fraction=0.035)
        axs[0, 3].set_title("Edge at t$_0$")

        if gt is not None:
            axs[1, 0].imshow(
                event_flow_image_blend(gt_event_flow, img3w, gt_event_mask)
            )
            axs[1, 2].imshow(flow_uv_to_img(gt_event_flow))
        else:
            na(axs[1, 0])
            na(axs[1, 2])
        axs[1, 0].set_title("GT Event Flow and Image Blend (before)")
        axs[1, 2].set_title("Estimated GT Event Flow")

        axs[2, 0].imshow(
            event_flow_image_blend(pred_event_flow, img3w, ev_mask_bef)
        )
        axs[2, 0].set_title("Predicted Event Flow and Image Blend (after)")
        axs[2, 2].imshow(flow_uv_to_img(pred_event_flow))
        axs[2, 2].set_title("Predicted Event Flow")

        axs[1, 1].imshow(overlay_events_on_image(xs_k, ys_k, img3w))
        axs[1, 1].set_title("Events+Image Overlay (before)")
        axs[2, 1].imshow(overlay_events_on_image(lwx, lwy, img3w))
        axs[2, 1].set_title("Events+Image Overlay (after)")

        for ax, (sx, sy), title in (
            (axs[1, 3], (xs_k, ys_k), "Scatter of Zero-Warped Events (before)"),
            (axs[2, 3], (lwx, lwy), "Scatter of Warped Events at t$_0$ (after)"),
        ):
            ax.scatter(sx, sy, marker="o", lw=0, alpha=0.2, s=2, c="black")
            ax.set(xlim=(0, sensor[1] - 1), ylim=(0, sensor[0] - 1))
            ax.invert_yaxis()
            ax.set_aspect("equal", "box")
            ax.set_title(title)

        for r in range(3):
            for c in range(3):
                axs[r, c].axis("off")
        axs[0, 3].axis("off")

        fig.tight_layout()
        path = self.plot_dir / f"end_result_{idx:06d}.png"
        fig.savefig(path, dpi=100, bbox_inches="tight")
        plt.close(fig)
        self.end_result_paths.append(path)
        return path

    # ----------------------------------------------------- metric sequences

    def _plot_sequence(self, values, name: str, better: str) -> Path:
        plt = _pyplot()
        fig, ax = plt.subplots(figsize=(10, 3.2))
        ax.plot(values, lw=1.2)
        ax.set_xlabel("window")
        ax.set_ylabel(f"{name} ({better})")
        ax.grid(alpha=0.3)
        m = float(np.mean(values))
        ax.axhline(m, color="tab:red", ls="--", lw=0.8)
        ax.set_title(f"{name}: mean {m:.4f}")
        path = self.plot_dir / f"seq_{name.lower()}.png"
        fig.savefig(path, dpi=110, bbox_inches="tight")
        plt.close(fig)
        return path

    def plot_metric_sequences(self, eval_results: Dict):
        """FWL / AEE / ANPE charts over the sequence
        (reference: plotters.py:860-974)."""
        keys = sorted(
            eval_results, key=lambda k: int(k.replace("datasample_idx_", ""))
        )

        def series(metric):
            vals = [
                float(np.asarray(eval_results[k]["evals"][metric]))
                for k in keys
                if metric in eval_results[k]["evals"]
            ]
            return vals

        made = []
        fwl = series("fwl")
        if fwl:
            made.append(self._plot_sequence(fwl, "FWL", "↑"))
        aee = series("AEE")
        if aee:
            made.append(self._plot_sequence(aee, "AEE", "↓"))
        for n in (1, 2, 3):
            s = series(f"A{n}PE")
            if s:
                made.append(self._plot_sequence(s, f"A{n}PE", "↓"))
        return made

    # ------------------------------------------------------- diagnostics

    def plot_nan_theta(self, idx: int, theta: np.ndarray) -> Optional[Path]:
        """Visualize NaN/Inf locations in a theta field.

        Numerical-debug aid mirroring the reference's NaN visualizer
        (plotters.py:299-381); returns None when the field is clean.
        """
        theta = np.asarray(theta)
        bad = ~np.isfinite(theta)
        if not bad.any():
            return None
        plt = _pyplot()
        fig, axes = plt.subplots(1, 2, figsize=(10, 4))
        for c, ax in enumerate(axes):
            ax.imshow(bad[..., c], cmap="Reds", interpolation="nearest")
            ax.set_title(f"non-finite theta[..., {c}] ({bad[..., c].sum()} px)")
            ax.axis("off")
        path = self.plot_dir / f"nan_theta_{idx:06d}.png"
        fig.savefig(path, dpi=110, bbox_inches="tight")
        plt.close(fig)
        return path

    def _level_shape(self, n_px: int):
        """(h, w) of a flattened pyramid-level theta with h*w == n_px.

        Pyramid levels keep the sensor's aspect ratio, so among the divisor
        pairs of n_px pick the one closest (in log-aspect) to the configured
        sensor; non-square sensors (DSEC 480x640) would break a sqrt() guess.
        """
        sh, sw = self.cfg.dataset.sensor_size
        target = np.log(sh / sw)
        best = (n_px, 1)
        for h in range(1, int(np.sqrt(n_px)) + 1):
            if n_px % h:
                continue
            for hh, ww in ((h, n_px // h), (n_px // h, h)):
                if abs(np.log(hh / ww) - target) < abs(
                    np.log(best[0] / best[1]) - target
                ):
                    best = (hh, ww)
        return best

    def plot_step_results(
        self, idx: int, staged: StagedSample, thetas, losses
    ) -> Path:
        """Optimization-trajectory figure for one window: loss curve plus the
        flow field at a few intermediate iterates.

        On-device-history analogue of the reference's per-step plots
        (plotters.py:493-645); `thetas` is (n_steps, D) flat iterates at the
        finest level, `losses` is (n_steps,).
        """
        thetas = np.asarray(thetas)
        losses = np.asarray(losses)
        n = len(losses)
        picks = sorted(set([0, n // 3, 2 * n // 3, n - 1])) if n else []

        plt = _pyplot()
        fig = plt.figure(figsize=(14, 4))
        ax0 = fig.add_subplot(1, len(picks) + 1, 1)
        ax0.plot(losses, lw=1.2)
        ax0.set_xlabel("iteration")
        ax0.set_ylabel("loss")
        ax0.grid(alpha=0.3)

        h, w = self._level_shape(thetas.shape[1] // 2) if thetas.size else (0, 0)
        for i, p in enumerate(picks):
            ax = fig.add_subplot(1, len(picks) + 1, i + 2)
            theta = thetas[p].reshape(h, w, 2)
            ax.imshow(flow_uv_to_img(theta))
            ax.set_title(f"iter {p}", fontsize=9)
            ax.axis("off")
        path = self.plot_dir / f"step_results_{idx:06d}.png"
        fig.savefig(path, dpi=110, bbox_inches="tight")
        plt.close(fig)
        return path

    def plot_step_result_detail(
        self,
        idx: int,
        staged: StagedSample,
        theta_full: np.ndarray,
        prev_theta_full: Optional[np.ndarray] = None,
        itr="--",
        pyr=0,
    ) -> Path:
        """The reference's 2x4 per-step figure (plotters.py:493-645):

            flow-distribution scatter | theta field | IWE t0 (gamma) | edge t0
            GT event flow             | pred event flow | IWE t1     | edge t1
        """
        w = staged.window
        sensor = tuple(self.cfg.dataset.sensor_size)
        ev = staged.eval_events
        xs = np.asarray(ev["x"], np.float64)
        ys = np.asarray(ev["y"], np.float64)
        ts = np.asarray(ev["t"], np.float64)
        theta = _numpy(theta_full)
        plt = _pyplot()

        wx, wy = _warp(theta_full, xs, ys, ts, w.edge_ts)
        with torch.no_grad():
            l_iwe = _numpy(
                normalize_to_unit_range(events_to_pdf_frame(wx[0], wy[0], sensor))
            )
            r_iwe = _numpy(
                normalize_to_unit_range(events_to_pdf_frame(wx[-1], wy[-1], sensor))
            )

        xi = np.clip(np.round(xs).astype(int), 0, sensor[1] - 1)
        yi = np.clip(np.round(ys).astype(int), 0, sensor[0] - 1)
        cur_1d = theta[yi, xi]
        prev_1d = (
            np.asarray(prev_theta_full)[yi, xi]
            if prev_theta_full is not None
            else None
        )
        gt = staged.gt_flow
        gt_1d = np.asarray(gt, np.float64)[yi, xi] if gt is not None else None

        ev_mask = _event_mask_np(xs, ys, sensor)
        pred_event_flow = np.where(ev_mask[..., None], theta, 0.0)

        fig, axs = plt.subplots(2, 4, figsize=(22, 9))
        fig.suptitle(
            f"{self.cfg.dataset.sequence_name} optimization step results "
            f"[idx={idx}, pyr={pyr}, itr={itr}]"
        )

        if gt_1d is not None:
            axs[0, 0].scatter(
                gt_1d[:, 0], gt_1d[:, 1], label="GT event flow",
                color="forestgreen", marker="H", lw=0, s=21, alpha=0.4,
            )
        if prev_1d is not None:
            axs[0, 0].scatter(
                prev_1d[:, 0], prev_1d[:, 1], label="pred event flow (prev)",
                color="cornflowerblue", marker="H", lw=0, s=27, alpha=0.35,
            )
        axs[0, 0].scatter(
            cur_1d[:, 0], cur_1d[:, 1], label="pred event flow (curr)",
            color="crimson", marker="H", lw=0, s=21, alpha=0.25,
        )
        axs[0, 0].grid(True)
        axs[0, 0].axis("equal")
        axs[0, 0].legend(markerscale=4, fontsize=7)
        axs[0, 0].set_title("Event Flow Distribution Trend")

        if gt is not None:
            gt_valid = (
                np.isfinite(np.asarray(gt)[..., 0])
                & np.isfinite(np.asarray(gt)[..., 1])
            )
            gt_ev = np.where(
                (gt_valid & ev_mask)[..., None], np.asarray(gt), 0.0
            )
            axs[1, 0].imshow(flow_uv_to_img(gt_ev))
        else:
            axs[1, 0].annotate(
                "N/A", (0.5, 0.5), xycoords="axes fraction",
                ha="center", va="center", fontsize=40, color="darkgray",
            )
        axs[1, 0].set_title("Groundtruth Event Flow")

        axs[0, 1].imshow(flow_uv_to_img(theta))
        axs[0, 1].set_title("Estimated 2D Velocity Field (Theta)")
        axs[1, 1].imshow(flow_uv_to_img(pred_event_flow))
        axs[1, 1].set_title("Predicted Event Flow")

        # gamma-compressed IWE renders (reference uses **0.382)
        for ax, img, title in (
            (axs[0, 2], l_iwe, "Image of Warped Events at t$_0$"),
            (axs[1, 2], r_iwe, "Image of Warped Events at t$_1$"),
            (axs[0, 3], _numpy(w.edges[0]), "Edge at t$_0$"),
            (axs[1, 3], _numpy(w.edges[-1]), "Edge at t$_1$"),
        ):
            shown = img ** 0.382 if title.startswith("Image") else img
            im = ax.imshow(shown, cmap="binary")
            fig.colorbar(im, ax=ax, fraction=0.035)
            ax.set_title(title)

        for ax in axs.ravel()[1:]:
            ax.axis("off")
        axs[0, 0].axis("on")

        fig.tight_layout()
        path = self.plot_dir / f"step_result_{idx:06d}_pyr{pyr}_itr{itr}.png"
        fig.savefig(path, dpi=100, bbox_inches="tight")
        plt.close(fig)
        return path

    def plot_handover(
        self,
        idx: int,
        theta: np.ndarray,
        prior_theta: np.ndarray,
        post_handover_theta: np.ndarray,
        alpha_ho: float = 0.0,
        pyr: int = 0,
    ) -> Path:
        """Handover diagnostic: solved theta / prior theta / blended theta
        side by side as flow images, solved weight annotated
        (reference: plotters.py:448-473 `plot_handover`)."""
        plt = _pyplot()
        fig, axs = plt.subplots(1, 3, figsize=(16, 5))
        fig.suptitle(
            f"Handover at pyr {pyr} [idx={idx}, "
            f"alpha_handover={float(alpha_ho):4.2f}]"
        )
        for ax, th, title in (
            (axs[0], theta, "Pre-Handover Theta"),
            (axs[1], prior_theta, "Prior (Preceding) Theta"),
            (
                axs[2],
                post_handover_theta,
                f"Post-Handover Theta (w={float(alpha_ho):4.2f})",
            ),
        ):
            ax.imshow(flow_uv_to_img(np.asarray(th)))
            ax.set_title(title)
            ax.axis("off")
        fig.tight_layout()
        path = self.plot_dir / f"handover_{idx:06d}_pyr{pyr}.png"
        fig.savefig(path, dpi=100, bbox_inches="tight")
        plt.close(fig)
        return path

    def plot_grad_quiver(
        self, idx: int, theta_full: np.ndarray, grad: np.ndarray, stride: int = 16
    ) -> Path:
        """Negative-gradient quiver over the flow map (reference
        plotters.py neg-grad-loss images)."""
        theta_full = np.asarray(theta_full)
        grad = np.asarray(grad)
        h, w = theta_full.shape[:2]
        ys, xs = np.mgrid[0:h:stride, 0:w:stride]
        plt = _pyplot()
        fig, ax = plt.subplots(figsize=(7, 5))
        ax.imshow(flow_uv_to_img(theta_full))
        g = grad[::stride, ::stride] if grad.shape[:2] == (h, w) else None
        if g is not None:
            ax.quiver(xs, ys, -g[..., 0], -g[..., 1], color="k", scale=None)
        ax.set_title(f"flow + negative loss gradient (window {idx})")
        ax.axis("off")
        path = self.plot_dir / f"grad_quiver_{idx:06d}.png"
        fig.savefig(path, dpi=110, bbox_inches="tight")
        plt.close(fig)
        return path

    # ------------------------------------------------------------- video

    def assemble_video(self, fps: int = 2, formats=("avi", "gif")) -> Optional[Path]:
        """Assemble the per-window end-result frames into a video.

        Writes an MJPEG .avi (the reference's cv.VideoWriter output format,
        exp_mgr.py:758-792, via our own RIFF writer — utils/avi.py) and an
        animated GIF. Frames are padded to the largest common size.
        """
        if not self.end_result_paths:
            return None
        from PIL import Image

        frames = [Image.open(p).convert("RGB") for p in self.end_result_paths]
        w = max(f.width for f in frames)
        h = max(f.height for f in frames)

        def padded(f):
            if (f.width, f.height) == (w, h):
                return f
            canvas = Image.new("RGB", (w, h), (255, 255, 255))
            canvas.paste(f, ((w - f.width) // 2, (h - f.height) // 2))
            return canvas

        frames = [padded(f) for f in frames]
        path = None
        if "avi" in formats:
            from eincm_tpu_torch.utils.avi import write_mjpeg_avi

            path = write_mjpeg_avi(
                [np.asarray(f) for f in frames],
                self.plot_dir / "end_results.avi",
                fps=fps,
            )
        if "gif" in formats:
            gif = self.plot_dir / "end_results.gif"
            frames[0].save(
                gif,
                save_all=True,
                append_images=frames[1:],
                duration=int(1000 / fps),
                loop=0,
            )
            path = path or gif
        return path
