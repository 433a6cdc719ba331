from upliftingtabletennis_torch.parallel.mesh import Mesh, dp_devices, make_mesh, replicate, shard_batch

__all__ = ["Mesh", "dp_devices", "make_mesh", "replicate", "shard_batch"]
