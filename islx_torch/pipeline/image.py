"""Single-image pose through the batched pipelines, a batch of one (port of
``islx/pipeline/image.py``).

The parity path (``islx_torch.pose.Body``/``Hand``) resizes every scale of
every image; this runs one image through the bucketed pipelines instead:
the frame is resized to its 184-row bucket and the peaks are taken there
(<= 1 px from the parity path, as in islx).

Two modes:

* default (``fused=False``): the body step, host hand boxes from the
  grouped skeletons (up to ``max_hands`` crops, several people), then the
  hand step on those crops cut from the same uploaded frame;
* ``fused=True``: one device pass a frame (:class:`FusedPosePipeline`:
  body CPM -> hand boxes on the device -> hand CPM), one crop per arm side.

The frame is uploaded once and resized to its bucket there with cv2's
``INTER_CUBIC``, as in islx, computed without cv2
(:func:`islx_torch.ops.resize_u8.upload_resized`): a frame already at its
bucket size passes through unresized.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from islx_torch.core import weights as W
from islx_torch.core.config import HandConfig, PoseConfig
from islx_torch.core.runtime import resolve_device
from islx_torch.ops.resize_u8 import upload_resized
from islx_torch.pipeline.batch_pose import (BatchedBodyPipeline,
                                            BatchedHandPipeline,
                                            FusedPosePipeline, bucket_for,
                                            detect_hand_boxes)


class ImagePose:
    """frame -> (candidate, subset, all_hand_peaks), production config.

    ``body_params``/``hand_params``: port weight states (float or int8), or
    None for the seeded random init. The body runs islx's
    ``PoseConfig(model_type, max_peaks=16)`` (``body.cfg``, or
    ``pipe.body.cfg`` fused). ``device`` defaults to ``"cuda"`` and raises
    without a GPU unless ``"cpu"`` is asked for."""

    def __init__(self, body_params: Optional[W.State] = None,
                 hand_params: Optional[W.State] = None,
                 model_type: str = "body25", max_hands: int = 4,
                 compute_dtype=torch.bfloat16, fused: bool = False,
                 hand_cfg: Optional[HandConfig] = None, device=None):
        self.device = resolve_device(device)
        self.model_type = model_type
        self.fused = fused
        if body_params is None:
            body_params = W.init_params(model_type)
        if hand_params is None:
            hand_params = W.init_params("hand")
        pose_cfg = PoseConfig(model_type=model_type, max_peaks=16)
        hand_cfg = hand_cfg or HandConfig.production()
        if fused:
            self.pipe = FusedPosePipeline(body_params, hand_params,
                                          model_type, pose_cfg, hand_cfg,
                                          compute_dtype=compute_dtype,
                                          device=self.device)
            self.max_hands = FusedPosePipeline.MAX_HANDS
        else:
            self.max_hands = max_hands
            self.body = BatchedBodyPipeline(body_params, model_type,
                                            pose_cfg,
                                            compute_dtype=compute_dtype,
                                            device=self.device)
            self.hand = BatchedHandPipeline(hand_params, hand_cfg,
                                            compute_dtype=compute_dtype,
                                            device=self.device)

    def __call__(self, img: np.ndarray
                 ) -> Tuple[np.ndarray, np.ndarray, List[np.ndarray]]:
        """BGR u8 [H,W,3] -> (candidate [N,4], subset [P,njoint+2], hand
        peaks: a [21,2] int64 array a detected hand), in the frame's
        coordinates."""
        h0, w0 = img.shape[:2]
        hb, wb = bucket_for(h0, w0, target_h=184)
        frames = upload_resized(img, hb, wb, self.device)
        sy, sx = h0 / hb, w0 / wb
        if self.fused:
            packed = self.pipe.device_step(frames, (h0, w0))
            results, boxes, peaks = self.pipe.assemble(packed, 1)
            (candidate, subset), = results
            hands = self.pipe.hands_for_frame(boxes, peaks, 0, sy, sx)
        else:
            flat = self.body.upload_frames(frames)
            packed = self.body.device_step_flat(flat, 1, hb, wb)
            results = self.body.assemble(packed, 1)
            boxes = detect_hand_boxes(results, hb, wb, (h0, w0),
                                      self.max_hands)
            (candidate, subset), = results
            hands = []
            if np.any(boxes[:, 3] > 0):
                peaks = self.hand.from_frames(flat, 1, hb, wb, boxes)
                for slot in range(self.max_hands):
                    if boxes[slot, 3] <= 0:
                        continue
                    pk = peaks[slot].astype(np.float64)
                    pk[:, 0] *= sx
                    pk[:, 1] *= sy
                    hands.append(np.rint(pk).astype(np.int64))
        if candidate.shape[0]:
            candidate[:, 0] *= sx
            candidate[:, 1] *= sy
        return candidate, subset, hands
