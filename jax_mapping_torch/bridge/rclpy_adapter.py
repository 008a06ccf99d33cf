"""Real ROS 2 boundary: bridge the in-process Bus to rclpy topics.

SURVEY.md §7's design stance — "keep the ROS 2 node graph as the plugin
boundary so the Thymio bridge, Nav2, and RViz remain untouched" — lands
here. The framework's whole graph runs on the in-process Bus (bridge/bus.py)
so it is testable anywhere; when rclpy IS installed, this adapter mirrors
the reference's exact topic surface onto real DDS:

  outbound (Bus -> ROS):  /map, /map_updates (nav_msgs/OccupancyGrid,
                          `server/rviz_config.rviz:152-165`),
                          /pose (geometry_msgs/PoseWithCovarianceStamped,
                          rviz_config.rviz:133-143) + /poses (PoseArray,
                          whole fleet),
                          /scan, /odom — per robot namespace for fleets:
                          /robot<i>/scan, /robot<i>/odom (brain.robot_ns;
                          plain /scan /odom for one robot, rviz:94-106,
                          main.py:217-224),
                          /frontiers_markers (visualization_msgs/
                          MarkerArray of clustered frontier goals — the
                          bundled RViz config's Frontiers display),
                          /voxel_points (sensor_msgs/PointCloud2 of the
                          3D voxel map's occupied centres; inert unless
                          the stack runs a voxel mapper),
                          /tf (tf2_ros broadcaster, main.py:202-215)
  inbound  (ROS -> Bus):  /cmd_vel (geometry_msgs/Twist — Nav2 or
                          teleop_twist_joy, report.pdf §III.A),
                          /initialpose + /goal_pose (RViz tools),
                          and optionally per-namespace /scan + /odom
                          (live-hardware mode: real ldlidar_stl_ros2
                          drivers feed the mapper)

so RViz with `configs/jax_mapping.rviz` and Nav2 subscribe/publish exactly
the contracts the reference wires up in
`server/thymio_project/launch/pc_server.launch.py:12-34`.

Import-guarded: everything degrades to a clear RuntimeError when rclpy is
absent (this image has no ROS); CI exercises the adapter against a stub
rclpy module (tests/test_rclpy_adapter.py).

A copy of the JAX package's `bridge/rclpy_adapter.py` over the port's bus,
messages, QoS and TF. A payload the port carries as a tensor (on the card
or not) comes to the host in the conversion, one device-to-host copy per
field (`_host`); numpy payloads pass through. The conversion runs on the
bus's delivery thread, after the publish: it adds no host read to the
mapper's tick.
"""

from __future__ import annotations

import math
import threading
from typing import Iterable, List, Optional

import numpy as np

from jax_mapping_torch.bridge.bus import Bus
from jax_mapping_torch.bridge.messages import (
    Header, LaserScan, OccupancyGrid, Odometry, Twist,
)
from jax_mapping_torch.bridge.qos import Reliability
from jax_mapping_torch.bridge.tf import TfTree
from jax_mapping_torch.config import SlamConfig


def _host(x, dtype=None) -> np.ndarray:
    """A message payload as numpy: a tensor copied to the host once, any
    other array-like through `np.asarray`."""
    if hasattr(x, "detach") and hasattr(x, "cpu"):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype)


def rclpy_available() -> bool:
    """True when the real ROS 2 python stack can be imported."""
    try:
        import rclpy  # noqa: F401
        import rclpy.node  # noqa: F401
        return True
    except Exception:
        return False


def _to_ros_time(TimeCls, stamp: float):
    sec = int(stamp)
    return TimeCls(sec=sec, nanosec=int((stamp - sec) * 1e9))


def _from_ros_time(t) -> float:
    return float(t.sec) + float(t.nanosec) * 1e-9


def _yaw_from_quat(q) -> float:
    """Planar yaw from a ROS quaternion (x/y ignored: yaw-only maps)."""
    return 2.0 * math.atan2(float(q.z), float(q.w))


class RclpyAdapter:
    """One rclpy node pair of publishers/subscriptions mirroring the Bus.

    Args:
      bus: the in-process Bus carrying the framework graph.
      cfg: SlamConfig (QoS + rates: scan is Best-Effort per report.pdf
        §V.A; /map latches transient-local for late-joining RViz).
      tf: TfTree to broadcast (map->odom, odom->base_link, static laser
        mount) at cfg.tf_publish_period_s.
      outbound: Bus topics re-published into ROS.
      inbound: ROS topics re-published onto the Bus.
      node_name: ROS node name.
      n_robots: fleet size; scan/odom bridge per robot namespace
        ("/scan" for one robot, "/robot<i>/scan" for fleets — the same
        brain.robot_ns convention the internal graph uses).
    """

    OUTBOUND_DEFAULT = ("map", "map_updates", "pose", "scan", "odom",
                        "frontiers", "voxel_points", "plan", "graph")
    INBOUND_DEFAULT = ("cmd_vel", "initialpose", "goal_pose")

    def __init__(self, bus: Bus, cfg: SlamConfig,
                 tf: Optional[TfTree] = None,
                 outbound: Iterable[str] = OUTBOUND_DEFAULT,
                 inbound: Iterable[str] = INBOUND_DEFAULT,
                 node_name: str = "jax_mapping_bridge",
                 n_robots: int = 1):
        if not rclpy_available():
            raise RuntimeError(
                "rclpy is not importable — the ROS 2 adapter needs a sourced "
                "ROS 2 (Jazzy) environment; see README 'ROS 2 / RViz'. The "
                "rest of the framework runs without it.")
        import rclpy
        from rclpy.node import Node as RosNode

        self.bus = bus
        self.cfg = cfg
        self.tf = tf
        self.n_robots = max(1, n_robots)
        self._subs: List = []
        self._spin_thread: Optional[threading.Thread] = None
        self._shutdown = threading.Event()

        if not rclpy.ok():
            rclpy.init()
        self.node: "RosNode" = RosNode(node_name)

        self._msgs = self._import_msgs()
        self._wire_outbound(set(outbound))
        self._wire_inbound(set(inbound))
        if tf is not None:
            self._wire_tf()

    # -- wiring -------------------------------------------------------------

    @staticmethod
    def _import_msgs():
        import geometry_msgs.msg as geo
        import nav_msgs.msg as nav
        import sensor_msgs.msg as sen
        import builtin_interfaces.msg as bi
        try:
            # common_interfaces ships it everywhere RViz runs, but a
            # stripped ros-base without it only loses the marker display.
            import visualization_msgs.msg as vis
        except Exception:
            vis = None
        try:
            # rviz_default_plugins depends on map_msgs; its absence only
            # downgrades /map_updates to full-grid republish.
            import map_msgs.msg as map_msgs
        except Exception:
            map_msgs = None
        return {"geo": geo, "nav": nav, "sen": sen, "bi": bi, "vis": vis,
                "map_msgs": map_msgs}

    def _ros_qos(self, *, best_effort: bool = False, latched: bool = False,
                 depth: int = 10):
        from rclpy.qos import (
            DurabilityPolicy, QoSProfile, ReliabilityPolicy,
        )
        return QoSProfile(
            depth=depth,
            reliability=(ReliabilityPolicy.BEST_EFFORT if best_effort
                         else ReliabilityPolicy.RELIABLE),
            durability=(DurabilityPolicy.TRANSIENT_LOCAL if latched
                        else DurabilityPolicy.VOLATILE),
        )

    # Bus-side topic names for each logical topic. The internal graph's
    # names are uneven on purpose-mirroring-the-reference grounds: the
    # mapper publishes slashed absolute names ("/map", "/pose"), while
    # per-robot sensor topics are namespaced UNslashed ("scan",
    # "robot0/scan" — brain.robot_ns). The adapter must use the exact
    # strings (Bus lookups are exact; tests/test_stack.py pins the graph).
    BUS_TOPICS = {
        "map": "/map", "map_updates": "/map_updates", "pose": "/pose",
        "frontiers": "/frontiers", "cmd_vel": "/cmd_vel",
        "initialpose": "/initialpose", "goal_pose": "/goal_pose",
        "scan": "scan", "odom": "odom",
        "voxel_points": "/voxel_points",
        "plan": "/plan",
        "graph": "/graph",
    }

    def _wire_outbound(self, topics) -> None:
        nav = self._msgs["nav"]
        geo = self._msgs["geo"]
        sen = self._msgs["sen"]
        n = self.node
        if "map" in topics:
            pub = n.create_publisher(nav.OccupancyGrid, "/map",
                                     self._ros_qos(latched=True, depth=1))
            self._bus_to_ros("map", pub, self.occupancy_to_ros)
        if "map_updates" in topics:
            # RViz's Map display reads map_msgs/OccupancyGridUpdate on its
            # update topic; publishing a full OccupancyGrid there is a
            # silent type clash. Convert when map_msgs is available.
            if self._msgs["map_msgs"] is not None:
                pub = n.create_publisher(
                    self._msgs["map_msgs"].OccupancyGridUpdate,
                    "/map_updates", self._ros_qos(depth=1))
                self._bus_to_ros("map_updates", pub,
                                 self.occupancy_to_ros_update)
            else:
                pub = n.create_publisher(nav.OccupancyGrid, "/map_updates",
                                         self._ros_qos(depth=1))
                self._bus_to_ros("map_updates", pub, self.occupancy_to_ros)
        if "pose" in topics:
            pub = n.create_publisher(geo.PoseWithCovarianceStamped, "/pose",
                                     self._ros_qos())
            self._bus_to_ros("pose", pub, self.pose_list_to_ros)
            pub_all = n.create_publisher(geo.PoseArray, "/poses",
                                         self._ros_qos())
            self._bus_to_ros("pose", pub_all, self.pose_list_to_ros_array)
        if "frontiers" in topics and self._msgs["vis"] is not None:
            # The bundled RViz config's MarkerArray display
            # (configs/jax_mapping_torch.rviz "/frontiers_markers") reads this.
            pub = n.create_publisher(self._msgs["vis"].MarkerArray,
                                     "/frontiers_markers",
                                     self._ros_qos(depth=1))
            self._bus_to_ros("frontiers", pub, self.frontiers_to_ros_markers)
        if "plan" in topics:
            # The global planner's path (bridge/planner.py) on the topic
            # Nav2's planners use; RViz's Path display reads it.
            pub = n.create_publisher(nav.Path, "/plan",
                                     self._ros_qos(depth=1))
            self._bus_to_ros("plan", pub, self.path_to_ros)
        if "graph" in topics and self._msgs["vis"] is not None:
            # The pose graph as markers (slam_toolbox's interactive-mode
            # graph view); same MarkerArray class as the frontier layer.
            pub = n.create_publisher(self._msgs["vis"].MarkerArray,
                                     "/graph", self._ros_qos(depth=1))
            self._bus_to_ros("graph", pub, self.graph_to_ros_markers)
        if "voxel_points" in topics:
            # The 3D voxel map as a point cloud (RViz PointCloud2
            # display) — published only when a voxel mapper runs; the
            # subscription is inert otherwise.
            pub = n.create_publisher(sen.PointCloud2, "/voxel_points",
                                     self._ros_qos(depth=1))
            self._bus_to_ros("voxel_points", pub, self.voxel_points_to_ros)
        if "scan" in topics:
            for ns in self._robot_namespaces():
                bus_t = ns + self.BUS_TOPICS["scan"]
                pub = n.create_publisher(sen.LaserScan, "/" + bus_t,
                                         self._ros_qos(best_effort=True))
                self._bus_to_ros_raw(bus_t, pub, self.scan_to_ros)
        if "odom" in topics:
            for ns in self._robot_namespaces():
                bus_t = ns + self.BUS_TOPICS["odom"]
                pub = n.create_publisher(nav.Odometry, "/" + bus_t,
                                         self._ros_qos())
                self._bus_to_ros_raw(bus_t, pub, self.odom_to_ros)

    def _robot_namespaces(self):
        from jax_mapping_torch.bridge.brain import robot_ns
        return [robot_ns(i, self.n_robots) for i in range(self.n_robots)]

    def _bus_to_ros(self, topic: str, ros_pub, convert) -> None:
        self._bus_to_ros_raw(self.BUS_TOPICS[topic], ros_pub, convert)

    def _bus_to_ros_raw(self, bus_topic: str, ros_pub, convert) -> None:
        def cb(msg, _pub=ros_pub, _cv=convert):
            out = _cv(msg)
            if out is not None:
                _pub.publish(out)
        self._subs.append(self.bus.subscribe(bus_topic, callback=cb))

    def _wire_inbound(self, topics) -> None:
        geo = self._msgs["geo"]
        sen = self._msgs["sen"]
        nav = self._msgs["nav"]
        n = self.node
        if "cmd_vel" in topics:
            pub = self.bus.publisher(self.BUS_TOPICS["cmd_vel"])
            n.create_subscription(
                geo.Twist, "/cmd_vel",
                lambda m, _p=pub: _p.publish(self.twist_from_ros(m)),
                self._ros_qos())
        if "scan" in topics:
            for ns in self._robot_namespaces():
                bus_t = ns + self.BUS_TOPICS["scan"]
                pub = self.bus.publisher(bus_t)
                n.create_subscription(
                    sen.LaserScan, "/" + bus_t,
                    lambda m, _p=pub: _p.publish(self.scan_from_ros(m)),
                    self._ros_qos(best_effort=True))
        if "odom" in topics:
            for ns in self._robot_namespaces():
                bus_t = ns + self.BUS_TOPICS["odom"]
                pub = self.bus.publisher(bus_t)
                n.create_subscription(
                    nav.Odometry, "/" + bus_t,
                    lambda m, _p=pub: _p.publish(self.odom_from_ros(m)),
                    self._ros_qos(depth=50))
        if "initialpose" in topics:
            # RViz's SetInitialPose tool (configs/jax_mapping_torch.rviz, the
            # reference's rviz_config.rviz:186-198 carries the same tool):
            # relocalize the SLAM estimate (mapper consumes the bus topic).
            pub = self.bus.publisher(self.BUS_TOPICS["initialpose"])
            n.create_subscription(
                geo.PoseWithCovarianceStamped, "/initialpose",
                lambda m, _p=pub: _p.publish(self.pose_cov_from_ros(m)),
                self._ros_qos())
        if "goal_pose" in topics:
            # RViz's SetGoal tool; consumed by the brain + global
            # planner (the reference never launched a consumer — Nav2
            # was future work, report.pdf VI.2). /goal_pose addresses
            # robot 0; fleets also get /robotN/goal_pose so an operator
            # can direct ANY robot (brain's per-robot goal topics).
            pub = self.bus.publisher(self.BUS_TOPICS["goal_pose"])
            n.create_subscription(
                geo.PoseStamped, "/goal_pose",
                lambda m, _p=pub: _p.publish(self.pose_stamped_from_ros(m)),
                self._ros_qos())
            if self.n_robots > 1:
                for ns in self._robot_namespaces():
                    bus_t = ns + "goal_pose"
                    npub = self.bus.publisher(bus_t)
                    n.create_subscription(
                        geo.PoseStamped, "/" + bus_t,
                        lambda m, _p=npub: _p.publish(
                            self.pose_stamped_from_ros(m)),
                        self._ros_qos())

    def _wire_tf(self) -> None:
        import tf2_ros
        self._tf_bcast = tf2_ros.TransformBroadcaster(self.node)
        self.node.create_timer(self.cfg.tf_publish_period_s,
                               self.publish_tf_once)

    # -- conversions (field-for-field per the ROS interface definitions) ----

    def scan_to_ros(self, msg: LaserScan):
        sen, bi = self._msgs["sen"], self._msgs["bi"]
        out = sen.LaserScan()
        out.header.stamp = _to_ros_time(bi.Time, msg.header.stamp)
        out.header.frame_id = msg.header.frame_id or "base_laser"
        out.angle_min = float(msg.angle_min)
        out.angle_max = float(msg.angle_max)
        out.angle_increment = float(msg.angle_increment)
        out.time_increment = float(msg.time_increment)
        out.scan_time = float(msg.scan_time)
        out.range_min = float(msg.range_min)
        out.range_max = float(msg.range_max)
        out.ranges = [float(r) for r in _host(msg.ranges)]
        out.intensities = [float(v) for v in _host(msg.intensities)]
        return out

    def scan_from_ros(self, m) -> LaserScan:
        return LaserScan(
            header=Header(stamp=_from_ros_time(m.header.stamp),
                          frame_id=m.header.frame_id),
            angle_min=float(m.angle_min), angle_max=float(m.angle_max),
            angle_increment=float(m.angle_increment),
            time_increment=float(m.time_increment),
            scan_time=float(m.scan_time),
            range_min=float(m.range_min), range_max=float(m.range_max),
            ranges=np.asarray(m.ranges, np.float32),
            intensities=np.asarray(m.intensities, np.float32),
        )

    def path_to_ros(self, msg):
        """Path -> nav_msgs/Path (PoseStamped per waypoint, identity
        orientation — the plan carries positions; heading comes from the
        brain's steering, not the path)."""
        nav, geo, bi = (self._msgs["nav"], self._msgs["geo"],
                        self._msgs["bi"])
        out = nav.Path()
        out.header.stamp = _to_ros_time(bi.Time, msg.header.stamp)
        out.header.frame_id = msg.header.frame_id or "map"
        poses = []
        for x, y in _host(msg.poses_xy, np.float32):
            ps = geo.PoseStamped()
            ps.header = out.header
            ps.pose.position.x = float(x)
            ps.pose.position.y = float(y)
            ps.pose.orientation.w = 1.0
            poses.append(ps)
        out.poses = poses
        return out

    def voxel_points_to_ros(self, msg):
        """VoxelPoints -> sensor_msgs/PointCloud2 (x/y/z float32, packed
        12-byte points) for the RViz PointCloud2 display."""
        sen, bi = self._msgs["sen"], self._msgs["bi"]
        pts = np.ascontiguousarray(_host(msg.points, np.float32))
        out = sen.PointCloud2()
        out.header.stamp = _to_ros_time(bi.Time, msg.header.stamp)
        out.header.frame_id = msg.header.frame_id or "map"
        out.height = 1
        out.width = int(pts.shape[0])
        fields = []
        for i, name in enumerate(("x", "y", "z")):
            f = sen.PointField()
            f.name = name
            f.offset = 4 * i
            f.datatype = 7                 # PointField.FLOAT32
            f.count = 1
            fields.append(f)
        out.fields = fields
        out.is_bigendian = False
        out.point_step = 12
        out.row_step = 12 * int(pts.shape[0])
        out.data = pts.tobytes()
        out.is_dense = True
        return out

    def occupancy_to_ros(self, msg: OccupancyGrid):
        nav, bi = self._msgs["nav"], self._msgs["bi"]
        out = nav.OccupancyGrid()
        out.header.stamp = _to_ros_time(bi.Time, msg.header.stamp)
        out.header.frame_id = msg.header.frame_id or "map"
        out.info.resolution = float(msg.info.resolution)
        out.info.width = int(msg.info.width)
        out.info.height = int(msg.info.height)
        out.info.origin.position.x = float(msg.info.origin.x)
        out.info.origin.position.y = float(msg.info.origin.y)
        # Planar map: the origin rotation is pure yaw, so the quaternion's
        # x and y components are identically zero and only z/w are set.
        qx, qy, qz, qw = msg.info.origin.to_quaternion()
        out.info.origin.orientation.z = qz
        out.info.origin.orientation.w = qw
        out.data = [int(v) for v in _host(msg.data, np.int8)]
        return out

    def odom_to_ros(self, msg: Odometry):
        nav, bi = self._msgs["nav"], self._msgs["bi"]
        out = nav.Odometry()
        out.header.stamp = _to_ros_time(bi.Time, msg.header.stamp)
        out.header.frame_id = msg.header.frame_id or "odom"
        out.child_frame_id = msg.child_frame_id
        out.pose.pose.position.x = float(msg.pose.x)
        out.pose.pose.position.y = float(msg.pose.y)
        qx, qy, qz, qw = msg.pose.to_quaternion()
        out.pose.pose.orientation.z = qz
        out.pose.pose.orientation.w = qw
        out.twist.twist.linear.x = float(msg.twist.linear_x)
        out.twist.twist.angular.z = float(msg.twist.angular_z)
        return out

    def odom_from_ros(self, m) -> Odometry:
        from jax_mapping_torch.bridge.messages import Pose2D
        yaw = _yaw_from_quat(m.pose.pose.orientation)
        return Odometry(
            header=Header(stamp=_from_ros_time(m.header.stamp),
                          frame_id=m.header.frame_id),
            child_frame_id=m.child_frame_id,
            pose=Pose2D(float(m.pose.pose.position.x),
                        float(m.pose.pose.position.y), yaw),
            twist=Twist(linear_x=float(m.twist.twist.linear.x),
                        angular_z=float(m.twist.twist.angular.z)),
        )

    def twist_from_ros(self, m) -> Twist:
        return Twist(linear_x=float(m.linear.x),
                     angular_z=float(m.angular.z))

    def pose_cov_from_ros(self, msg) -> "Pose2D":
        """geometry_msgs/PoseWithCovarianceStamped -> planar Pose2D."""
        from jax_mapping_torch.bridge.messages import Pose2D
        p = msg.pose.pose
        return Pose2D(float(p.position.x), float(p.position.y),
                      _yaw_from_quat(p.orientation))

    def pose_stamped_from_ros(self, msg) -> "Pose2D":
        """geometry_msgs/PoseStamped -> planar Pose2D."""
        from jax_mapping_torch.bridge.messages import Pose2D
        p = msg.pose
        return Pose2D(float(p.position.x), float(p.position.y),
                      _yaw_from_quat(p.orientation))

    def pose_list_to_ros(self, poses):
        """The Bus `/pose` payload is a list of per-robot pose dicts
        (bridge/mapper.py); ROS `/pose` is the FIRST robot's
        PoseWithCovarianceStamped (the reference is single-robot,
        rviz_config.rviz:133-143). The fleet view goes out as a
        PoseArray on `/poses` (see pose_list_to_ros_array)."""
        if not poses:
            return None
        geo, bi = self._msgs["geo"], self._msgs["bi"]
        p = poses[0]
        out = geo.PoseWithCovarianceStamped()
        out.header.stamp = _to_ros_time(bi.Time, p.get("stamp", 0.0))
        out.header.frame_id = "map"
        out.pose.pose.position.x = float(p["x"])
        out.pose.pose.position.y = float(p["y"])
        out.pose.pose.orientation.z = math.sin(p["theta"] / 2.0)
        out.pose.pose.orientation.w = math.cos(p["theta"] / 2.0)
        cov = p.get("cov")
        if cov is not None:
            # Row-major 6x6 (x y z r p y): the correlative matcher's
            # surface covariance (ops/scan_match MatchResult.cov) on the
            # x/x, y/y and yaw/yaw diagonals — what slam_toolbox's
            # PoseWithCovariance carries.
            c = [0.0] * 36
            c[0], c[7], c[35] = float(cov[0]), float(cov[1]), float(cov[2])
            out.pose.covariance = c
        return out

    def pose_list_to_ros_array(self, poses):
        """All robots' poses as one geometry_msgs/PoseArray (`/poses`)."""
        if not poses:
            return None
        geo, bi = self._msgs["geo"], self._msgs["bi"]
        out = geo.PoseArray()
        out.header.stamp = _to_ros_time(bi.Time, poses[0].get("stamp", 0.0))
        out.header.frame_id = "map"
        arr = []
        for p in poses:
            m = geo.Pose()
            m.position.x = float(p["x"])
            m.position.y = float(p["y"])
            m.orientation.z = math.sin(p["theta"] / 2.0)
            m.orientation.w = math.cos(p["theta"] / 2.0)
            arr.append(m)
        out.poses = arr
        return out

    def occupancy_to_ros_update(self, msg: OccupancyGrid):
        """Full-extent map_msgs/OccupancyGridUpdate (x=y=0, whole grid):
        the type RViz's Map display expects on its update topic."""
        mm = self._msgs["map_msgs"]
        bi = self._msgs["bi"]
        u = mm.OccupancyGridUpdate()
        u.header.stamp = _to_ros_time(bi.Time, msg.header.stamp)
        u.header.frame_id = msg.header.frame_id or "map"
        u.x = 0
        u.y = 0
        u.width = int(msg.info.width)
        u.height = int(msg.info.height)
        u.data = [int(v) for v in _host(msg.data).ravel()]
        return u

    def frontiers_to_ros_markers(self, msg):
        """FrontierArray -> visualization_msgs/MarkerArray: one sphere per
        live cluster at its goal target, sized by cluster size, green when
        some robot claimed it, orange when unassigned. A DELETEALL leads
        so stale clusters vanish between updates."""
        vis = self._msgs["vis"]
        if vis is None:
            return None
        bi = self._msgs["bi"]
        out = vis.MarkerArray()
        clear = vis.Marker()
        clear.action = 3                      # DELETEALL
        markers = [clear]
        assigned = {int(a) for a in _host(msg.assignment) if a >= 0}
        for k, (xy, size) in enumerate(zip(_host(msg.targets_xy),
                                           _host(msg.sizes))):
            if size <= 0:
                continue
            m = vis.Marker()
            m.header.stamp = _to_ros_time(bi.Time, msg.header.stamp)
            m.header.frame_id = "map"
            m.ns = "frontiers"
            m.id = k
            m.type = 2                        # SPHERE
            m.action = 0                      # ADD
            m.pose.position.x = float(xy[0])
            m.pose.position.y = float(xy[1])
            m.pose.orientation.w = 1.0
            s = 0.15 + 0.01 * min(float(size), 50.0)
            m.scale.x = m.scale.y = m.scale.z = s
            m.color.a = 0.9
            if k in assigned:
                m.color.g = 1.0
            else:
                m.color.r = 1.0
                m.color.g = 0.6
            markers.append(m)
        out.markers = markers
        return out

    def graph_to_ros_markers(self, msg):
        """GraphMarkers -> MarkerArray: one SPHERE_LIST per robot's nodes
        (color cycled per robot), one LINE_LIST of gray odometry edges,
        one LINE_LIST of red loop constraints. DELETEALL leads so a
        thinned/reset graph vanishes cleanly."""
        vis = self._msgs["vis"]
        if vis is None:
            return None
        bi = self._msgs["bi"]
        stamp = _to_ros_time(bi.Time, msg.header.stamp)

        def mk(ns, mid, mtype):
            m = vis.Marker()
            m.header.stamp = stamp
            m.header.frame_id = "map"
            m.ns = ns
            m.id = mid
            m.type = mtype
            m.action = 0
            m.pose.orientation.w = 1.0
            return m

        def pt(xy):
            g = self._msgs["geo"].Point()
            g.x, g.y, g.z = float(xy[0]), float(xy[1]), 0.02
            return g

        out = vis.MarkerArray()
        clear = vis.Marker()
        clear.action = 3                      # DELETEALL
        markers = [clear]
        nodes = _host(msg.nodes_xy)
        nrob = _host(msg.node_robot)
        palette = [(0.2, 0.6, 1.0), (1.0, 0.8, 0.2), (0.6, 1.0, 0.4),
                   (1.0, 0.4, 0.8)]
        for r in sorted(set(int(x) for x in nrob)):
            m = mk("graph_nodes", r, 7)       # SPHERE_LIST
            m.scale.x = m.scale.y = m.scale.z = 0.06
            cr, cg, cb = palette[r % len(palette)]
            m.color.r, m.color.g, m.color.b, m.color.a = cr, cg, cb, 0.9
            m.points = [pt(xy) for xy in nodes[nrob == r]]
            markers.append(m)
        edges = _host(msg.edges_xy)
        isloop = _host(msg.edge_is_loop)
        for name, mid, sel, col in (
                ("graph_edges", 0, ~isloop, (0.6, 0.6, 0.6)),
                ("graph_loops", 1, isloop, (1.0, 0.2, 0.2))):
            m = mk(name, mid, 5)              # LINE_LIST
            m.scale.x = 0.015
            m.color.r, m.color.g, m.color.b = col
            m.color.a = 0.8
            pts = []
            for e in edges[sel] if len(edges) else []:
                pts += [pt(e[0]), pt(e[1])]
            m.points = pts
            markers.append(m)
        out.markers = markers
        return out

    def publish_tf_once(self) -> None:
        """Broadcast every transform currently in the TfTree."""
        geo, bi = self._msgs["geo"], self._msgs["bi"]
        out = []
        for t in self.tf.all_transforms():
            m = geo.TransformStamped()
            m.header.stamp = _to_ros_time(bi.Time, t.header.stamp)
            m.header.frame_id = t.header.frame_id
            m.child_frame_id = t.child_frame_id
            m.transform.translation.x = float(t.x)
            m.transform.translation.y = float(t.y)
            m.transform.translation.z = float(t.z)
            m.transform.rotation.z = math.sin(t.theta / 2.0)
            m.transform.rotation.w = math.cos(t.theta / 2.0)
            out.append(m)
        if out:
            self._tf_bcast.sendTransform(out)

    # -- lifecycle ----------------------------------------------------------

    def spin(self) -> None:
        """rclpy.spin in a daemon thread (the reference's pattern,
        `server/.../main.py:285-286`)."""
        import rclpy

        def run():
            while not self._shutdown.is_set() and rclpy.ok():
                rclpy.spin_once(self.node, timeout_sec=0.1)

        self._spin_thread = threading.Thread(target=run, daemon=True)
        self._spin_thread.start()

    def shutdown(self) -> None:
        self._shutdown.set()
        if self._spin_thread is not None:
            self._spin_thread.join(timeout=2.0)
        for s in self._subs:
            s.close()
        try:
            self.node.destroy_node()
        except Exception:
            pass
