from .mesh import create_mesh, batch_sharding, shard_batch, replicate
from .consensus import consensus_admm, solve_batched_sharded
from .dcg import distributed_cg
from .spatial import sharded_denoise
