"""Online (middleware-fed) sensor provider + visualization hub.

Port of ``sadvio_tpu/pipeline/online.py`` (numpy and threads, no device
work).  Middleware-agnostic equivalent of the reference's ROS2 layer
(reference: ros/src/sensorSubscriber.h:12-255 [image+IMU callbacks bridged
into the provider queue via sync_process], ros/src/rosVisualizer.h:78-604
[pose/trajectory/cloud/mesh publishing], and the queue semantics of
cpp/src/dataproviders/adataprovider.cpp:14-26,257-270).

Any middleware (ROS2 via rclpy — see sadvio_tpu_torch/ros2_node.py — a socket
server, a test harness) pushes raw samples through `push_image` / `push_imu`
callbacks; `OnlineProvider` applies the reference's timestamp sync rules
(stereo partner within 20 ms, image/IMU ordering, IMU batch covering
(last_t, t]; EUROCGrabber at adataprovider.cpp:373-483) and emits the same
`FrameData` the offline provider yields, so the SLAM pipelines are
provider-agnostic.

Fixes designed in rather than ported: the reference's `next()` spin-waits on
a *locally constructed* mutex (adataprovider.cpp:14-26 — a no-op lock); here
a single condition variable guards the queue (no spinning, no race), and
back-pressure drops the oldest frame beyond `max_queue` instead of growing
without bound.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Callable, Optional

import numpy as np

from sadvio_tpu_torch.pipeline.synthetic import FrameData


class OnlineProvider:
    """Push-driven frame assembly with EuRoC-grabber sync semantics."""

    def __init__(self, n_cams: int = 2, *, stereo_gate_s: float = 0.020,
                 max_queue: int = 8,
                 enhance: Optional[Callable[[np.ndarray], np.ndarray]] = None):
        self.n_cams = n_cams
        self.stereo_gate_s = stereo_gate_s
        self.max_queue = max_queue
        self.enhance = enhance
        self._pending = [deque() for _ in range(n_cams)]  # (ts, img)
        self._imu = deque()  # (ts, acc, gyr)
        self._frames = deque()
        self._last_t = None
        self._cv = threading.Condition()
        self._closed = False

    # -- middleware-facing callbacks -------------------------------------

    def push_image(self, cam: int, ts: float, img: np.ndarray):
        img = np.asarray(img, np.float32)
        if self.enhance is not None:
            img = self.enhance(img)
        with self._cv:
            self._pending[cam].append((float(ts), img))
            self._try_assemble_locked()

    def push_imu(self, ts: float, acc, gyr):
        with self._cv:
            self._imu.append((float(ts), np.asarray(acc, np.float32),
                              np.asarray(gyr, np.float32)))
            self._try_assemble_locked()

    def close(self):
        with self._cv:
            self._closed = True
            self._cv.notify_all()

    # -- pipeline-facing --------------------------------------------------

    def next(self, timeout: Optional[float] = None) -> Optional[FrameData]:
        """Block until a synchronized frame is ready (None on close/timeout).

        Condition-variable wait replaces the reference's spin-wait
        (adataprovider.cpp:19-20).
        """
        with self._cv:
            ok = self._cv.wait_for(
                lambda: self._frames or self._closed, timeout)
            if not ok or (not self._frames and self._closed):
                return None
            if not self._frames:
                return None
            return self._frames.popleft()

    def __iter__(self):
        while True:
            f = self.next()
            if f is None:
                return
            yield f

    # -- sync core (caller holds the lock) --------------------------------

    def _try_assemble_locked(self):
        while self._assemble_one_locked():
            pass

    def _assemble_one_locked(self) -> bool:
        if not self._pending[0]:
            return False
        t0, img0 = self._pending[0][0]
        imgs = [img0]
        picked = []
        for c in range(1, self.n_cams):
            q = self._pending[c]
            # drop partners older than the gate (EUROCGrabber :409-414)
            while q and q[0][0] < t0 - self.stereo_gate_s:
                q.popleft()
            if not q or abs(q[0][0] - t0) > self.stereo_gate_s:
                # partner may still arrive; but if cam0 lags far behind, drop
                if q and q[0][0] > t0 + self.stereo_gate_s:
                    self._pending[0].popleft()
                    return bool(self._pending[0])
                return False
            picked.append(c)
            imgs.append(q[0][1])
        # need IMU coverage up to t0 before emitting (ordering guarantee)
        if self._imu and self._imu[-1][0] < t0 and not self._closed:
            return False
        self._pending[0].popleft()
        for c in picked:
            self._pending[c].popleft()

        acc, gyr, dts = [], [], []
        last = self._last_t
        while self._imu and self._imu[0][0] <= t0:
            ts_i, a, g = self._imu.popleft()
            if last is not None:
                acc.append(a)
                gyr.append(g)
                dts.append(ts_i - last)
            last = ts_i
        if self._last_t is None:
            acc, gyr, dts = [], [], []
        frame = FrameData(
            ts=float(t0), images=np.stack(imgs),
            acc=np.asarray(acc, np.float32).reshape(-1, 3),
            gyr=np.asarray(gyr, np.float32).reshape(-1, 3),
            dt=np.asarray(dts, np.float32),
        )
        self._last_t = t0
        self._frames.append(frame)
        while len(self._frames) > self.max_queue:
            self._frames.popleft()  # back-pressure: drop oldest
        self._cv.notify_all()
        return True


class VisualizerHub:
    """Publish/subscribe fan-out for SLAM outputs.

    The middleware-agnostic core of RosVisualizer (rosVisualizer.h:84-95,
    195-565): the pipeline publishes typed events (pose, trajectory, local
    cloud, mesh, image-with-tracks); any number of sinks (a ROS2 node, a
    file writer, a test probe) subscribe.  Replaces the reference's shared
    `_frame_to_display` pointer handoff (slamCore.h:62-65) with an explicit
    queue per subscriber — no torn reads.
    """

    TOPICS = ("pose", "trajectory", "local_cloud", "global_cloud",
              "mesh", "tracks_image", "dense_cloud")

    def __init__(self):
        self._subs = {t: [] for t in self.TOPICS}
        self._lock = threading.Lock()

    def subscribe(self, topic: str, fn: Callable):
        if topic not in self._subs:
            raise KeyError(f"unknown topic {topic!r}; one of {self.TOPICS}")
        with self._lock:
            self._subs[topic].append(fn)

    def publish(self, topic: str, payload):
        with self._lock:
            sinks = list(self._subs[topic])
        for fn in sinks:
            fn(payload)

    def publish_keyframe(self, *, R, t, traj=None, cloud=None, mesh=None):
        """Convenience: one KF's worth of outputs, mirroring the per-KF
        publishing block of rosVisualizer.h:568-604."""
        self.publish("pose", {"R": np.asarray(R), "t": np.asarray(t)})
        if traj is not None:
            self.publish("trajectory", np.asarray(traj))
        if cloud is not None:
            self.publish("local_cloud", np.asarray(cloud))
        if mesh is not None:
            self.publish("mesh", mesh)
