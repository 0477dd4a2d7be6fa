"""Single-slice visual test driver.

The port of the JAX package's ``nm03-test-pipeline``, mirroring the
reference's ``test_pipeline`` (src/test/test_pipeline.cpp:29-182): one 2D
slice through every stage, each intermediate exported as a JPEG to
``out-test/`` (the reference's golden-eyeball testing surface). The input
is a flag (``--input``, or a generated phantom by default); the reference's
5-pane window (original, preprocessed, segmentation, erosion, dilation,
test_pipeline.cpp:148-158) is the set of exported stage images plus one
composed panel, so nothing blocks and it runs headless. Run it as

    python -m nm03_capstone_project_tpu_torch.cli.test_pipeline

It runs on the GPU unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import sys

from nm03_capstone_project_tpu_torch.cli import common


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="nm03-test-pipeline", description=__doc__.strip().splitlines()[0]
    )
    p.add_argument("--input", default=None, help=".dcm slice to process (default: synthetic phantom)")
    p.add_argument("--output", default="out-test", help="stage-image output directory")
    common.add_device_arg(p)
    p.add_argument(
        "--show",
        action="store_true",
        help="display the 5 stage panes in a blocking window (the reference's "
        "MultiViewWindow::run(), test_pipeline.cpp:148-158); requires a display",
    )
    p.add_argument("--verbose", action="store_true")
    common.add_pipeline_args(p)
    return p


def show_panel(exports: dict) -> bool:
    """Blocking 5-pane viewer mirroring MultiViewWindow (test_pipeline.cpp:148-158).

    Returns False, with a warning, when no GUI backend is usable: the
    exported panel JPEG is then the view.
    """
    import os

    try:
        if sys.platform.startswith("linux") and not (
            os.environ.get("DISPLAY") or os.environ.get("WAYLAND_DISPLAY")
        ):
            raise RuntimeError("no display available")
        import matplotlib.pyplot as plt

        fig, axes = plt.subplots(1, len(exports), figsize=(23, 4.5), facecolor="black")
        for ax, (name, img) in zip(axes, exports.items()):
            ax.imshow(img, cmap="gray" if img.ndim == 2 else None)
            ax.set_title(name, color="white", fontsize=9)
            ax.set_facecolor("black")
            ax.axis("off")
        fig.tight_layout()
        plt.show()  # blocking, like multiWindow->run()
        plt.close(fig)
        return True
    except Exception as e:  # noqa: BLE001 — headless/backend failure
        print(f"--show unavailable ({e!r}); see the exported pipeline_panel.jpg",
              file=sys.stderr)
        return False


def stage_renders(padded, dims, cfg, device=None) -> dict:
    """The 5 exported stage renders (uint8 numpy arrays), keyed by the
    reference's export names (test_pipeline.cpp:162-179: original and
    preprocessed as grayscale renders, segmentation / erosion / dilation as
    white-label renders, all through the 512x512 letterbox)."""
    import torch

    from nm03_capstone_project_tpu_torch.pipeline.slice_pipeline import process_slice_stages
    from nm03_capstone_project_tpu_torch.render.render import render_gray, render_segmentation

    stages = process_slice_stages(padded, dims, cfg, device=device)
    dims_t = torch.as_tensor(dims, dtype=torch.int32, device=stages["original_image"].device)
    if not bool(stages["grow_converged"]):
        print(
            "WARNING: region growing hit its iteration cap; the segmentation "
            "under-covers (raise --grow-max-iters)"
        )

    def seg_render(m):
        return render_segmentation(
            m, dims_t, cfg.render_size, cfg.overlay_opacity,
            cfg.overlay_border_opacity, cfg.overlay_border_radius,
        )

    renders = {
        "original_image": render_gray(stages["original_image"], dims_t, cfg.render_size),
        "preprocessed_image": render_gray(stages["preprocessed_image"], dims_t, cfg.render_size),
        "segmentation": seg_render(stages["segmentation"]),
        "erosion_result": seg_render(stages["erosion_result"]),
        "final_dilated_result": seg_render(stages["final_dilated_result"]),
    }
    return {name: img.cpu().numpy() for name, img in renders.items()}


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    try:
        return run(args)
    except Exception as e:  # noqa: BLE001
        print(f"Fatal error: {e}", file=sys.stderr)
        return 1


def run(args: argparse.Namespace) -> int:
    import numpy as np

    from nm03_capstone_project_tpu_torch.core.backend import resolve_device
    from nm03_capstone_project_tpu_torch.data.synthetic import phantom_slice
    from nm03_capstone_project_tpu_torch.render.contact_sheet import contact_sheet
    from nm03_capstone_project_tpu_torch.render.export import clean_directory, save_jpeg
    from nm03_capstone_project_tpu_torch.utils.reporter import configure_reporting

    configure_reporting(verbose=args.verbose)
    common.apply_native_flag(args)
    device = resolve_device(args.device)
    cfg = common.pipeline_config_from_args(args)

    if args.input:
        from nm03_capstone_project_tpu_torch.data.dicomlite import read_dicom

        pixels = read_dicom(args.input).pixels
    else:
        pixels = phantom_slice(256, 256, seed=17)

    h, w = pixels.shape
    if h > cfg.canvas or w > cfg.canvas:
        raise ValueError(f"slice {w}x{h} exceeds canvas {cfg.canvas}; raise --canvas")
    padded = np.zeros((cfg.canvas, cfg.canvas), np.float32)
    padded[:h, :w] = pixels
    dims = np.asarray([h, w], np.int32)

    # the reference clean-recreates out-test (test_pipeline.cpp:13-14)
    clean_directory(args.output)

    exports = stage_renders(padded, dims, cfg, device=device)
    for name, img in exports.items():
        save_jpeg(img, f"{args.output}/{name}.jpg")
        print(f"exported {args.output}/{name}.jpg")

    # the 5-pane window (MultiViewWindow, test_pipeline.cpp:148-158), as a
    # composed strip a headless run can still eyeball
    sheet = contact_sheet(list(exports.values()), labels=list(exports))
    save_jpeg(sheet, f"{args.output}/pipeline_panel.jpg")
    print(f"exported {args.output}/pipeline_panel.jpg")

    if args.show:
        show_panel(exports)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
