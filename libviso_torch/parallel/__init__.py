"""Scale-out: device meshes, sequence-sharded, staged and tensor-parallel
odometry and landmark-sharded bundle adjustment (port of
``libviso_tpu/parallel``)."""

from libviso_torch.parallel.mesh import make_mesh, make_pipe_mesh
from libviso_torch.parallel.pp_odometry import (
    build_pipelined_program,
    run_pipelined_odometry,
)
from libviso_torch.parallel.odometry import (
    build_chunk_odometry,
    chunk_frames_with_halo,
    host_chunk_assignment,
    run_sharded_odometry,
    run_sharded_odometry_multihost,
    stitch_chunk_motions,
)
from libviso_torch.parallel.ba_sharding import sharded_bundle_adjust
from libviso_torch.parallel.tp_matching import (
    build_tp_matcher,
    tp_match_descriptors,
)

__all__ = [
    "make_mesh",
    "make_pipe_mesh",
    "build_chunk_odometry",
    "build_pipelined_program",
    "run_pipelined_odometry",
    "build_tp_matcher",
    "chunk_frames_with_halo",
    "host_chunk_assignment",
    "run_sharded_odometry",
    "run_sharded_odometry_multihost",
    "sharded_bundle_adjust",
    "stitch_chunk_motions",
    "tp_match_descriptors",
]
