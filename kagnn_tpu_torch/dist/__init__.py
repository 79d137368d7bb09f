"""Distribution over `torch.distributed`, the counterpart of
`kagnn_tpu/dist/`: the halo-exchange node partition (`halo.py`), the edge
partition with all-reduce (`partition.py`), data parallelism
(`sharded.py`), rank layouts (`mesh.py`), the multi-host bootstrap
(`init.py`) and the single-host launcher (`launch.py`)."""
from kagnn_tpu_torch.dist.halo import (HaloPlan, build_halo_plan,  # noqa: F401
                                       halo_scaling_report, make_halo_node_step)
from kagnn_tpu_torch.dist.init import initialize_multihost  # noqa: F401
from kagnn_tpu_torch.dist.launch import launch  # noqa: F401
from kagnn_tpu_torch.dist.mesh import make_mesh  # noqa: F401
from kagnn_tpu_torch.dist.partition import (  # noqa: F401
    make_edge_partitioned_node_step, pad_edges_to, scaling_report)
from kagnn_tpu_torch.dist.sharded import (make_sharded_train_step,  # noqa: F401
                                          shard_stacked_batch, stack_batches)
