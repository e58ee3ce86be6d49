"""KITTI odometry dataset I/O — the kittiHelper equivalent
(reference: src/kittiHelper.cpp) plus the evaluation pose writer
(reference: src/laserMapping.cpp:2284-2326).

Host-side NumPy/stdlib code: file I/O is not compute-path work.  The
camera→LiDAR ground-truth re-axing uses the fixed rotation
R = [[0,0,1],[-1,0,0],[0,-1,0]] (kittiHelper.cpp:75-77).
"""

from __future__ import annotations

import os
import queue
import threading
from dataclasses import dataclass
from typing import Iterator, Optional, Tuple

import numpy as np

try:  # native C loader (see native/loam_native.c); pure-NumPy fallback
    from light_loam_tpu import _native
except ImportError:  # pragma: no cover - extension not built
    _native = None

# camera frame -> lidar frame rotation (kittiHelper.cpp:76)
R_CAM_TO_LIDAR = np.array(
    [[0.0, 0.0, 1.0], [-1.0, 0.0, 0.0], [0.0, -1.0, 0.0]], dtype=np.float64
)


def read_lidar_bin(path: str) -> np.ndarray:
    """Read a KITTI velodyne .bin: float32 records (x, y, z, intensity)
    (kittiHelper.cpp:22-32,137-148).  Returns (N, 4) float32."""
    data = np.fromfile(path, dtype=np.float32)
    return data.reshape(-1, 4)


def read_lidar_bin_padded(path: str, capacity: int):
    """Read a .bin straight into a fixed-capacity padded layout.

    Returns (xyz (capacity, 3) f32, intensity (capacity,) f32,
    mask (capacity,) bool).  Uses the native C loader when built (single
    pass, GIL released during I/O); falls back to NumPy."""
    if _native is not None:
        xyz, inten, n_valid, _n_total = _native.read_bin_padded(path, capacity)
    else:
        pts = read_lidar_bin(path)
        n_valid = min(len(pts), capacity)
        xyz = np.zeros((capacity, 3), np.float32)
        inten = np.zeros((capacity,), np.float32)
        xyz[:n_valid] = pts[:n_valid, :3]
        inten[:n_valid] = pts[:n_valid, 3]
    mask = np.zeros((capacity,), bool)
    mask[:n_valid] = True
    return xyz, inten, mask


def read_times(path: str) -> np.ndarray:
    return np.loadtxt(path, dtype=np.float64).reshape(-1)


def read_gt_poses(path: str) -> np.ndarray:
    """Read a KITTI ground-truth/result pose file: each row a 3×4
    row-major camera-frame pose.  Returns (N, 3, 4) float64."""
    raw = np.loadtxt(path, dtype=np.float64)
    return raw.reshape(-1, 3, 4)


def gt_to_lidar_frame(gt: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Re-axe GT from camera to lidar frame like kittiHelper.cpp:105-108:
    q = q_transform * q_cam (rotation only on the left), t = R_transform·t.
    Returns (R (N,3,3), t (N,3))."""
    Rw = R_CAM_TO_LIDAR[None] @ gt[:, :, :3]
    t = (R_CAM_TO_LIDAR @ gt[:, :, 3].T).T
    return Rw, t


@dataclass
class KittiSequence:
    """Iterates (timestamp, points (N,4)) frames of one sequence, with the
    reference's directory layout (kittiHelper.cpp:65-69,128-130)."""

    dataset_folder: str
    sequence: str

    def __post_init__(self):
        self.times = read_times(
            os.path.join(self.dataset_folder, "sequences", self.sequence, "times.txt")
        )
        gt_path = os.path.join(self.dataset_folder, "results", f"{self.sequence}.txt")
        self.gt = read_gt_poses(gt_path) if os.path.exists(gt_path) else None

    def __len__(self) -> int:
        return len(self.times)

    def frame_path(self, i: int) -> str:
        return os.path.join(
            self.dataset_folder, "velodyne", "sequences", self.sequence,
            "velodyne", f"{i:06d}.bin",
        )

    def __iter__(self) -> Iterator[Tuple[float, np.ndarray]]:
        for i in range(len(self)):
            yield self.times[i], read_lidar_bin(self.frame_path(i))

    def padded_frames(
        self, capacity: int, prefetch: int = 2
    ) -> Iterator[Tuple[float, np.ndarray, np.ndarray]]:
        """Stream (timestamp, xyz (cap,3), mask) with a background reader
        thread — disk I/O overlaps device compute (the async host data
        path the reference delegates to a separate ROS process)."""
        q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        stop = threading.Event()

        def put_checked(item) -> bool:
            """Bounded put that re-checks `stop` so an early-stopping
            consumer (e.g. run_kitti with max_frames) can't leave the
            thread blocked forever on a full queue."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for i in range(len(self)):
                    if stop.is_set():
                        return
                    xyz, _inten, mask = read_lidar_bin_padded(
                        self.frame_path(i), capacity
                    )
                    if not put_checked((self.times[i], xyz, mask)):
                        return
                put_checked(None)
            except BaseException as e:  # noqa: BLE001 - surfaced to consumer
                # a dead reader must not leave the consumer blocked on
                # q.get() forever: ship the exception as the sentinel
                put_checked(e)

        th = threading.Thread(target=worker, daemon=True)
        th.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            th.join(timeout=5.0)


class KittiPoseWriter:
    """Append first-pose-relative 3×4 poses in KITTI format
    (laserMapping.cpp:2284-2326): H_rel = H_init⁻¹ · H, written row-major
    in %e with 6 digits, space-separated, one pose per line."""

    def __init__(self, path: str):
        self.path = path
        self._h_init_inv: Optional[np.ndarray] = None
        # truncate like a fresh run (the reference appends, so stale files
        # would corrupt evaluation; start clean)
        open(path, "w").close()

    def write(self, R: np.ndarray, t: np.ndarray) -> None:
        H = np.eye(4, dtype=np.float64)
        H[:3, :3] = R
        H[:3, 3] = t
        if self._h_init_inv is None:
            self._h_init_inv = np.linalg.inv(H)
        H = self._h_init_inv @ H
        row = H[:3, :].reshape(-1)
        with open(self.path, "a") as f:
            f.write(" ".join(f"{v:.6e}" for v in row) + "\n")


def main():
    """Dataset replay / inspection CLI — the kittiHelper role
    (kittiHelper.cpp:34-178) without ROS: stream a sequence at
    10/publish_delay Hz, report frame stats, optionally re-axe and dump
    the ground truth to a lidar-frame trajectory file."""
    import argparse
    import time as _time

    ap = argparse.ArgumentParser(description="KITTI sequence replay")
    ap.add_argument("--dataset", required=True)
    ap.add_argument("--sequence", default="04")
    ap.add_argument("--publish-delay", type=int, default=1,
                    help="rate divisor like the reference's publish_delay")
    ap.add_argument("--frames", type=int, default=None)
    ap.add_argument("--gt-out", default=None,
                    help="write lidar-frame GT trajectory (KITTI 3x4 rows)")
    ap.add_argument("--no-sleep", action="store_true",
                    help="replay as fast as possible")
    args = ap.parse_args()

    seq = KittiSequence(args.dataset, args.sequence)
    period = args.publish_delay / 10.0
    if args.gt_out and seq.gt is not None:
        R, t = gt_to_lidar_frame(seq.gt)
        with open(args.gt_out, "w") as f:
            for i in range(len(R)):
                row = np.concatenate([R[i], t[i][:, None]], axis=1).reshape(-1)
                f.write(" ".join(f"{v:.6e}" for v in row) + "\n")
        print(f"lidar-frame GT written to {args.gt_out}")

    n = 0
    for ts, pts in seq:
        print(f"frame {n}: t={ts:.3f}s  {len(pts)} points")
        n += 1
        if args.frames is not None and n >= args.frames:
            break
        if not args.no_sleep:
            _time.sleep(period)
    print(f"replayed {n} frames")


if __name__ == "__main__":
    main()
