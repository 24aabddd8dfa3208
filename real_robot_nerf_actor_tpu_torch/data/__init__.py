"""Robot I/O and recorded demos (PLY and PNG files, keyframes, calibration,
ReplaySource), the kitchen writer and its manifests, the native PLY loader,
the synthetic scene (numpy only, but for the text tower the writer runs),
the RealSense depth filters and image augmentation. Exports the JAX
package's `data` names."""
from real_robot_nerf_actor_tpu_torch.data.ply import read_ply, write_ply
from real_robot_nerf_actor_tpu_torch.data.keyframes import (
    KeyframeDemo, extract_keyframes, parse_xarm_position_file)
from real_robot_nerf_actor_tpu_torch.data.replay import (
    PointCloudSample, ReplayRobotIO, ReplaySource, RobotIO)
from real_robot_nerf_actor_tpu_torch.data.synthetic import (
    SyntheticScene, make_synthetic_demo, make_synthetic_scene)

__all__ = ["KeyframeDemo", "PointCloudSample", "ReplayRobotIO", "ReplaySource", "RobotIO",
           "SyntheticScene", "extract_keyframes", "make_synthetic_demo",
           "make_synthetic_scene", "parse_xarm_position_file", "read_ply", "write_ply"]
