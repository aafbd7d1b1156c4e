"""NOCS-REAL275 dataset loader.

The port's own copy of bundletrack_tpu/data/nocs.py.  Mirrors the reference
loader's conventions (reference: src/DataLoader.cpp:60-243 DataLoaderNOCS —
hardcoded REAL275 intrinsics:75-77, scene id parsed from the data_dir,
`<id>_color.png` / `<id>_depth.png` frame files, 6-PACK data-list
mode:105-145 selecting frames from
NOCS-REAL275-additional/data_list/real_val/<class_id>/<model>/list.txt,
ground-truth init pose from converted text poses:80-86).  Frames are
decoded ahead on threads (data/native_io.SequencePrefetcher).
"""

from __future__ import annotations

import os
import re
from typing import Optional

import numpy as np

from bundletrack_tpu_torch.data.native_io import SequencePrefetcher, read_png
from bundletrack_tpu_torch.data.ycbineoat import FrameData, _to_gray, _to_gray_u8

# reference src/DataLoader.cpp:75-77
NOCS_K = np.array([[591.0125, 0, 322.525], [0, 590.16775, 244.11084], [0, 0, 1]], np.float32)

SYNSET_NAMES = ["BG", "bottle", "bowl", "camera", "can", "laptop", "mug"]


def class_id_for_model(model_name: str) -> int:
    for i, name in enumerate(SYNSET_NAMES[1:], start=1):
        if name in model_name:
            return i
    return 0


class NocsLoader:
    """Iterates FrameData of one NOCS scene; exposes K and the init pose."""

    def __init__(
        self,
        data_dir: str,
        model_name: str,
        mask_dir: Optional[str] = None,
        use_6pack_datalist: bool = False,
        gt_dir: Optional[str] = None,
        zfar: float = 2.0,
    ):
        self.data_dir = data_dir
        self.model_name = model_name
        self.mask_dir = mask_dir
        self.zfar = zfar
        # the reference hardcodes the REAL275 intrinsics (DataLoader.cpp:
        # 75-77); an optional cam_K.txt in data_dir takes their place (lets
        # small synthetic scenes use the same layout)
        k_file = os.path.join(data_dir, "cam_K.txt")
        self.K = (
            np.loadtxt(k_file).reshape(3, 3).astype(np.float32) if os.path.exists(k_file) else NOCS_K.copy()
        )
        m = re.search(r"scene_(\d+)", data_dir)
        self.scene_id = int(m.group(1)) if m else 1

        if use_6pack_datalist:
            class_id = class_id_for_model(model_name)
            datalist = os.path.join(
                data_dir, "..", "..", "NOCS-REAL275-additional", "data_list", "real_val",
                str(class_id), model_name, "list.txt",
            )
            ids = []
            with open(datalist) as f:
                for line in f:
                    line = line.strip()
                    if f"scene_{self.scene_id}" in line:
                        ids.append(line.split("/")[-1])
            self.ids = ids
        else:
            self.ids = sorted(f[: -len("_color.png")] for f in os.listdir(data_dir) if f.endswith("_color.png"))
        if not self.ids:
            raise FileNotFoundError(f"no frames found for {data_dir}")
        self.color_files = [os.path.join(data_dir, i + "_color.png") for i in self.ids]
        self.depth_files = [os.path.join(data_dir, i + "_depth.png") for i in self.ids]

        self.gt_dir = gt_dir
        self.ob_in_cam0 = np.eye(4, dtype=np.float32)
        if gt_dir and os.path.isdir(gt_dir):
            gt_files = sorted(os.listdir(gt_dir))
            if gt_files:
                self.ob_in_cam0 = np.loadtxt(os.path.join(gt_dir, gt_files[0])).reshape(4, 4).astype(np.float32)

        self._color_pf = SequencePrefetcher(self.color_files)
        self._depth_pf = SequencePrefetcher(self.depth_files)

    def __len__(self):
        return len(self.ids)

    def close(self) -> None:
        """Stop the decoding threads."""
        self._color_pf.close()
        self._depth_pf.close()

    @property
    def init_pose_in_model(self) -> np.ndarray:
        return np.linalg.inv(self.ob_in_cam0)

    def __getitem__(self, idx: int) -> FrameData:
        color = self._color_pf.get(idx)
        depth_raw = self._depth_pf.get(idx)
        depth = depth_raw.astype(np.float32) / 1000.0
        depth[(depth < 0.1) | (depth > self.zfar)] = 0.0
        mask = np.ones(depth.shape, bool)
        if self.mask_dir:
            p = os.path.join(self.mask_dir, self.ids[idx] + ".png")
            if os.path.exists(p):
                m = read_png(p)
                mask = (m[..., 0] if m.ndim == 3 else m) > 0
        return FrameData(
            gray=_to_gray(color),
            color=color,
            depth=depth,
            mask=mask,
            frame_id=self.ids[idx],
            gray_u8=_to_gray_u8(color),
            depth_u16=depth_raw.astype(np.uint16),
        )
