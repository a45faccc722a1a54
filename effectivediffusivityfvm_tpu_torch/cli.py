"""Command-line entry point, input.txt-compatible (torch port of
``effectivediffusivityfvm_tpu.cli``).

Reference: ``main`` (Deff2D.cu:3-54) reads a hardcoded ``input.txt`` and
dispatches on nPhase x BatchFlag.  Here the file path is an optional argv
(defaulting to ``input.txt`` for parity) and the same four pipelines are
dispatched; an ``InputName`` ending in ``.npy``/``.npz``, or a batch whose
``ImageDir`` holds ``00000.npy``, takes the 3D voxel pipelines instead.
The solve runs on the CUDA device unless ``main`` is called with
``device="cpu"``.

Usage:
    python -m effectivediffusivityfvm_tpu_torch.cli [input.txt]
"""

from __future__ import annotations

import os
import sys

import numpy as np

from .config import format_options, parse_input_file
from .pipeline.batch import batch_sim, batch_sim_3phase
from .pipeline.single import resolve_device, single_sim, single_sim_3phase


def main(argv=None, device="cuda") -> int:
    argv = sys.argv[1:] if argv is None else argv
    path = argv[0] if argv else "input.txt"
    try:
        cfg = parse_input_file(path)
    except FileNotFoundError:
        print(f"Error: input file '{path}' not found.")
        return 1
    except ValueError as e:
        print(f"Error: invalid input file: {e}")
        return 1
    if cfg.verbose:
        print(format_options(cfg))

    try:
        resolve_device(device)
    except RuntimeError as e:
        print(f"Error: {e}")
        return 1
    try:
        return _dispatch(cfg, device)
    except FileNotFoundError as e:
        print(f"Error: could not read image: {e}")
        return 1
    except (ValueError, NotImplementedError) as e:
        print(f"Error: {e}")
        return 1


def _dispatch(cfg, device) -> int:
    if cfg.input_name.endswith((".npy", ".npz")) and not cfg.batch_flag:
        # 3D voxel volume (no reference equivalent; BASELINE config 5)
        from .pipeline.volume import volume_sim, volume_sim_3phase

        vol = np.load(cfg.input_name)
        if hasattr(vol, "files"):
            vol = vol[vol.files[0]]
        if cfg.n_phase == 2:
            volume_sim(cfg, vol, write_output=True, device=device)
        else:
            volume_sim_3phase(cfg, vol, write_output=True, device=device)
        return 0
    if cfg.batch_flag and os.path.exists(os.path.join(cfg.image_dir,
                                                      "00000.npy")):
        # 3D voxel batch (%05d.npy in ImageDir)
        from .pipeline.volume import volume_batch_sim, volume_batch_sim_3phase

        vols = [np.load(os.path.join(cfg.image_dir, f"{i:05d}.npy"))
                for i in range(cfg.num_images)]
        run = volume_batch_sim if cfg.n_phase == 2 else volume_batch_sim_3phase
        run(cfg, vols, device=device)
        return 0
    if cfg.n_phase == 2:
        if not cfg.batch_flag:
            single_sim(cfg, device=device)
        else:
            batch_sim(cfg, device=device)
    elif cfg.n_phase == 3:
        if not cfg.batch_flag:
            single_sim_3phase(cfg, device=device)
        else:
            batch_sim_3phase(cfg, device=device)
    else:
        print("Current option entered for Phases is not supported.\n Exiting now.")
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
