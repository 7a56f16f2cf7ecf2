"""ROS2 bridge: sensor subscriber + visualizer publisher over OnlineProvider.

Port of ``sadvio_tpu/ros2_node.py``; the pipeline runs on the CUDA card
unless the ``device`` parameter names another.  Parity surface for the reference's ROS2 wrapper
(reference: ros/src/main.cpp:9-66 [node bring-up, front/back-end threads,
visualizer thread], ros/src/sensorSubscriber.h:12-255 [raw+compressed image
and IMU subscriptions bridged to the provider queue],
ros/src/rosVisualizer.h:78-604 [pose/path/odometry/cloud/mesh publishers]).

Everything ROS-specific is constructed lazily inside `main()`, so the
module imports without rclpy; the sync/queue logic lives in
`pipeline/online.py` (middleware-agnostic, unit-tested), and this module is
a thin adapter: ROS messages in -> OnlineProvider; VisualizerHub events ->
ROS messages out.
"""

from __future__ import annotations

import threading

import numpy as np

from sadvio_tpu_torch.pipeline.online import OnlineProvider, VisualizerHub


def _require_rclpy():
    try:
        import rclpy  # noqa: F401
        return True
    except ImportError as e:  # pragma: no cover - no ROS here
        raise RuntimeError(
            "ros2_node requires rclpy (a ROS2 installation); in ROS-less "
            "environments drive OnlineProvider directly") from e


def decode_compressed(data) -> np.ndarray:
    """Decode a compressed image payload (PNG/JPEG bytes) to float32 gray.

    Middleware-agnostic half of the CompressedImage subscription
    (sensorSubscriber.h handles raw AND compressed topics; the reference
    decodes via cv::imdecode).  Pillow is the decoder here; color frames
    collapse to the channel mean like the raw path."""
    import io

    from PIL import Image as PILImage

    img = np.asarray(PILImage.open(io.BytesIO(bytes(data))))
    if img.ndim == 3:
        img = img.mean(-1)
    return img.astype(np.float32)


def make_sensor_node(node, provider: OnlineProvider, *, cam_topics,
                     imu_topic: str,
                     compressed=False):  # pragma: no cover - needs rclpy
    """Wire ROS subscriptions into the provider (sensorSubscriber.h:75-188).

    ``compressed``: bool or per-camera sequence of bools -- subscribe the
    corresponding topic as sensor_msgs/CompressedImage (payload decoded by
    ``decode_compressed``) instead of raw Image.
    """
    from sensor_msgs.msg import CompressedImage, Image, Imu

    def on_image(cam):
        def cb(msg):
            img = np.frombuffer(msg.data, np.uint8).reshape(
                msg.height, msg.width, -1)
            if img.shape[-1] == 3:
                img = img.mean(-1)
            else:
                img = img[..., 0]
            ts = msg.header.stamp.sec + 1e-9 * msg.header.stamp.nanosec
            provider.push_image(cam, ts, img.astype(np.float32))
        return cb

    def on_compressed(cam):
        def cb(msg):
            ts = msg.header.stamp.sec + 1e-9 * msg.header.stamp.nanosec
            provider.push_image(cam, ts, decode_compressed(msg.data))
        return cb

    if not hasattr(compressed, "__len__"):
        compressed = [bool(compressed)] * len(cam_topics)
    elif len(compressed) != len(cam_topics):
        raise ValueError(
            f"compressed has {len(compressed)} entries for "
            f"{len(cam_topics)} camera topics")
    subs = [
        node.create_subscription(CompressedImage, t, on_compressed(c), 10)
        if compressed[c]
        else node.create_subscription(Image, t, on_image(c), 10)
        for c, t in enumerate(cam_topics)
    ]

    def on_imu(msg):
        ts = msg.header.stamp.sec + 1e-9 * msg.header.stamp.nanosec
        a = msg.linear_acceleration
        w = msg.angular_velocity
        provider.push_imu(ts, [a.x, a.y, a.z], [w.x, w.y, w.z])

    subs.append(node.create_subscription(Imu, imu_topic, on_imu, 200))
    return subs


def make_visualizer(node, hub: VisualizerHub, *, frame_id="world"
                    ):  # pragma: no cover - needs rclpy
    """Wire VisualizerHub topics to ROS publishers (rosVisualizer.h:84-95)."""
    from geometry_msgs.msg import PoseStamped
    from nav_msgs.msg import Path
    from sensor_msgs.msg import PointCloud2, PointField
    import std_msgs.msg

    pose_pub = node.create_publisher(PoseStamped, "slam/pose", 10)
    path_pub = node.create_publisher(Path, "slam/trajectory", 10)
    cloud_pub = node.create_publisher(PointCloud2, "slam/local_cloud", 5)
    path = Path()
    path.header.frame_id = frame_id

    def quat(R):
        w = np.sqrt(max(0.0, 1.0 + R[0, 0] + R[1, 1] + R[2, 2])) / 2.0
        d = max(4.0 * w, 1e-9)
        return np.asarray([(R[2, 1] - R[1, 2]) / d, (R[0, 2] - R[2, 0]) / d,
                           (R[1, 0] - R[0, 1]) / d, w])

    def on_pose(p):
        msg = PoseStamped()
        msg.header.frame_id = frame_id
        msg.pose.position.x, msg.pose.position.y, msg.pose.position.z = \
            map(float, p["t"])
        q = quat(p["R"])
        (msg.pose.orientation.x, msg.pose.orientation.y,
         msg.pose.orientation.z, msg.pose.orientation.w) = map(float, q)
        pose_pub.publish(msg)
        path.poses.append(msg)
        path_pub.publish(path)

    def cloud_msg(xyz):
        xyz = np.asarray(xyz, np.float32)
        msg = PointCloud2()
        msg.header = std_msgs.msg.Header(frame_id=frame_id)
        msg.height, msg.width = 1, xyz.shape[0]
        msg.fields = [
            PointField(name=n, offset=4 * i, datatype=PointField.FLOAT32,
                       count=1) for i, n in enumerate("xyz")]
        msg.point_step, msg.row_step = 12, 12 * xyz.shape[0]
        msg.data = xyz.tobytes()
        return msg

    # local/global cloud split (rosVisualizer.h publishes both: the live
    # window landmarks and the archived global map)
    global_pub = node.create_publisher(PointCloud2, "slam/global_cloud", 5)
    dense_pub = node.create_publisher(PointCloud2, "slam/dense_cloud", 5)
    hub.subscribe("local_cloud", lambda x: cloud_pub.publish(cloud_msg(x)))
    hub.subscribe("global_cloud", lambda x: global_pub.publish(cloud_msg(x)))
    hub.subscribe("dense_cloud", lambda x: dense_pub.publish(cloud_msg(x)))

    # mesh triangle list (rosVisualizer.h:195-565 publishMesh)
    from visualization_msgs.msg import Marker

    mesh_pub = node.create_publisher(Marker, "slam/mesh", 2)

    def on_mesh(payload):
        verts = np.asarray(payload["vertices"], np.float32)  # (V,3)
        tri = np.asarray(payload["triangles"], np.int64)  # (T,3)
        m = Marker()
        m.header.frame_id = frame_id
        m.type = Marker.TRIANGLE_LIST
        m.action = Marker.ADD
        m.scale.x = m.scale.y = m.scale.z = 1.0
        m.color.r, m.color.g, m.color.b, m.color.a = 0.3, 0.7, 1.0, 0.5
        from geometry_msgs.msg import Point

        for a, b, c in tri:
            for i in (a, b, c):
                m.points.append(Point(x=float(verts[i, 0]),
                                      y=float(verts[i, 1]),
                                      z=float(verts[i, 2])))
        mesh_pub.publish(m)

    hub.subscribe("pose", on_pose)
    hub.subscribe("mesh", on_mesh)


def main(args=None):  # pragma: no cover - needs rclpy
    """`ros2 run`-style entry (ros/src/main.cpp semantics): node + provider
    + SLAM thread + visualizer."""
    _require_rclpy()
    import rclpy
    from rclpy.node import Node

    rclpy.init(args=args)
    node = Node("sadvio_tpu_torch")
    node.declare_parameter("config_dir", "")
    node.declare_parameter("device", "cuda")
    provider = OnlineProvider(n_cams=2)
    hub = VisualizerHub()
    make_sensor_node(node, provider,
                     cam_topics=["cam0/image_raw", "cam1/image_raw"],
                     imu_topic="imu0")
    make_visualizer(node, hub)

    import os

    from sadvio_tpu_torch.pipeline.config import load_dataset_config, load_slam_config
    from sadvio_tpu_torch.pipeline.euroc import rig_from_dataset
    from sadvio_tpu_torch.run_euroc import build_slam, imu_params_of

    cfg_dir = node.get_parameter("config_dir").value
    device = node.get_parameter("device").value
    cfg = load_slam_config(os.path.join(cfg_dir, "config.yaml"))
    ds = load_dataset_config(os.path.join(cfg_dir, "dataset.yaml"))
    slam = build_slam(cfg, rig_from_dataset(ds, device), imu_params_of(ds), device)
    host = lambda x: x.cpu().numpy()

    def run_slam():
        for frame in provider:
            out = slam.process_frame(frame)
            if not out.get("is_kf"):
                continue
            w = slam.window
            hub.publish_keyframe(R=host(slam.R_cur), t=host(slam.t_cur),
                                 cloud=host(w.lmk)[host(w.lmk_mask)])
            gm = slam.global_map_state
            if gm is not None:
                hub.publish("global_cloud", host(gm.pos)[host(gm.mask)])
            if slam.mesher is not None:
                tri = host(slam.mesher.tri)[host(slam.mesher.tri_mask)]
                hub.publish("mesh", {"vertices": host(w.lmk), "triangles": tri})
                dense = slam.mesher.dense_points()
                if len(dense):
                    hub.publish("dense_cloud", dense)

    t = threading.Thread(target=run_slam, daemon=True)
    t.start()
    try:
        rclpy.spin(node)
    finally:
        provider.close()
        rclpy.shutdown()


if __name__ == "__main__":  # pragma: no cover
    main()
