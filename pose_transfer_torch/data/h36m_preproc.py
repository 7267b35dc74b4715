"""Human3.6M offline preprocessing: background-masked, square-cropped frames.

Counterpart of ``pose_transfer_tpu/data/h36m_preproc.py`` (the reference's
``proc_bg_h36m.py``), the offline tool that turns raw H36M videos into the
224×224 foreground JPEGs the dataset reads:

- walks subject/action/subaction/camera combinations, resolving each video
  file name through the H36M ``metadata.xml`` mapping;
- masks the foreground with the ground-truth background videos (``bg >
  100 → 1``, multiplied);
- square-pads the per-frame bbox of ``matlab_meta.mat`` and crops and
  resizes to 224×224;
- keeps every 5th frame, naming frames
  ``s_SS_act_AA_subact_SS_ca_CC_FFFFFF.jpg``.

The resize is ``resize_linear_u8``, numpy's counterpart of
``cv2.resize(..., INTER_LINEAR)`` on uint8 (OpenCV's 11-bit fixed-point
weights and its vectorised rounding). ``process_h36m`` imports ``cv2``
only to decode the videos and write the frames, and ``scipy.io`` to read
the boxes; it needs the raw H36M release on disk (not shipped).
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ElementTree

import numpy as np

SUBJECT_LIST = (1, 5, 6, 7, 8, 9, 11)
ACTION_LIST = tuple(range(2, 17))
SUBACTION_LIST = (1, 2)
CAMERA_LIST = (1, 2, 3, 4)


_COEF_BITS = 11            # OpenCV's INTER_RESIZE_COEF_BITS


def _linear_coeffs(n_out: int, n_in: int):
    """OpenCV's INTER_LINEAR taps and fixed-point weights along one axis:
    (first tap, second tap, weight 0, weight 1), the weights rounded from
    f32 fractions to 11 bits each, borders clamped to one tap."""
    f = ((np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = (f - s).astype(np.float32)
    clamp = (s < 0) | (s >= n_in - 1)
    f[clamp] = 0
    s = np.clip(s, 0, n_in - 1)
    scale = np.float32(1 << _COEF_BITS)
    a0 = np.rint((np.float32(1) - f) * scale).astype(np.int64)
    a1 = np.rint(f * scale).astype(np.int64)
    return s, np.minimum(s + 1, n_in - 1), a0, a1


def resize_linear_u8(image: np.ndarray, out_hw: tuple[int, int]) -> np.ndarray:
    """(H, W, C) uint8 → (h, w, C) uint8 as ``cv2.resize(image, (w, h))``
    (INTER_LINEAR): the horizontal pass in integers scaled by 2^11, the
    vertical one as OpenCV's vector code rounds it ((row >> 4)·β >> 16,
    summed, +2 >> 2). Equal to cv2's bytes on downscales; cv2's scalar
    tails may round an upscale's pixel one level differently."""
    h_out, w_out = out_hw
    x = np.asarray(image).astype(np.int64)
    sx, sx1, ax0, ax1 = _linear_coeffs(w_out, x.shape[1])
    sy, sy1, by0, by1 = _linear_coeffs(h_out, x.shape[0])
    rows = x[:, sx] * ax0[:, None] + x[:, sx1] * ax1[:, None]
    out = (((rows[sy] >> 4) * by0[:, None, None]) >> 16) \
        + (((rows[sy1] >> 4) * by1[:, None, None]) >> 16)
    return np.clip((out + 2) >> 2, 0, 255).astype(np.uint8)


def square_pad_bbox(bb: np.ndarray, img_w: int, img_h: int) -> np.ndarray:
    """The reference's square padding of [x0, y0, x1, y1]: clamp, pad the
    short side symmetrically, clamp again."""
    bb = bb.astype(np.float64).copy()
    bb[bb < 0] = 0
    bb[2] = min(bb[2], img_w)
    bb[3] = min(bb[3], img_h)
    bb = np.round(bb)
    if bb[3] - bb[1] > bb[2] - bb[0]:
        pad = ((bb[3] - bb[1]) - (bb[2] - bb[0])) / 2
        bb[2] += pad
        bb[0] -= pad
    else:
        pad = ((bb[2] - bb[0]) - (bb[3] - bb[1])) / 2
        bb[3] += pad
        bb[1] -= pad
    bb[bb < 0] = 0
    bb[2] = min(bb[2], img_w)
    bb[3] = min(bb[3], img_h)
    return np.round(bb).astype(np.int32)


def mask_foreground(image: np.ndarray, bg_image: np.ndarray) -> np.ndarray:
    """bg pixels > 100 become the pass-through mask."""
    bg = bg_image.copy()
    bg[bg > 100] = 1
    return np.multiply(image, bg)


def process_frame(image: np.ndarray, bg_image: np.ndarray, bb: np.ndarray,
                  out_size: int = 224) -> np.ndarray:
    """Mask, square-crop and resize one frame."""
    fg = mask_foreground(image, bg_image)
    bb = square_pad_bbox(np.asarray(bb), image.shape[1], image.shape[0])
    crop = fg[bb[1]:bb[3], bb[0]:bb[2], :]
    return resize_linear_u8(crop, (out_size, out_size))


def video_name_for(xml_mapping, xml_cameras, subject: int, action: int,
                   subaction: int, camera: int) -> str:
    """The .mp4 name from metadata.xml."""
    base = xml_mapping[int(action * 2 + subaction - 2)][int(subject + 1)].text
    cam = xml_cameras[0][int(camera - 1)].text
    return f"{base}.{cam}.mp4"


def process_h36m(root_dir: str, xml_path: str, annot_path: str,
                 save_path: str, *, subjects=SUBJECT_LIST,
                 actions=ACTION_LIST, subactions=SUBACTION_LIST,
                 cameras=CAMERA_LIST, frame_stride: int = 5,
                 out_size: int = 224, annot_name: str = "matlab_meta.mat",
                 limit_frames: int | None = None) -> int:
    """Full sweep; returns the number of frames written."""
    try:
        import cv2
    except ImportError as e:
        raise ImportError("process_h36m needs cv2 (opencv-python) to decode "
                          "the H36M videos and write the frames") from e
    import scipy.io as sio

    xml_file = ElementTree.parse(xml_path)
    xml_mapping = xml_file.find("mapping")
    xml_cameras = xml_file.find("dbcameras")
    written = 0

    for subject in subjects:
        for action in actions:
            for subaction in subactions:
                for camera in cameras:
                    name = "s_{:02d}_act_{:02d}_subact_{:02d}_ca_{:02d}" \
                        .format(subject, action, subaction, camera)
                    os.makedirs(os.path.join(save_path, name), exist_ok=True)
                    vid_name = video_name_for(xml_mapping, xml_cameras,
                                              subject, action, subaction,
                                              camera)
                    vid = os.path.join(root_dir, f"S{subject}", "Videos",
                                       vid_name)
                    bg_vid = os.path.join(root_dir, f"S{subject}",
                                          "ground_truth_bs", vid_name)
                    annot = os.path.join(annot_path, name, annot_name)
                    if not (os.path.exists(vid) and os.path.exists(bg_vid)
                            and os.path.exists(annot)):
                        continue
                    bboxx = sio.loadmat(annot)["bbox"].transpose(1, 0)
                    cap = cv2.VideoCapture(vid)
                    bg_cap = cv2.VideoCapture(bg_vid)
                    index = 0
                    while True:
                        ok, image = cap.read()
                        ok_bg, bg_image = bg_cap.read()
                        index += 1
                        if not (ok and ok_bg):
                            break
                        if (index - 1) % frame_stride != 0:
                            continue
                        frame = process_frame(image, bg_image,
                                              bboxx[index - 1], out_size)
                        out = os.path.join(
                            save_path, name,
                            f"{name}_{index:06d}.jpg")
                        cv2.imwrite(out, frame)
                        written += 1
                        if limit_frames and written >= limit_frames:
                            return written
    return written
