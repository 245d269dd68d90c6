"""Device meshes, parameter sharding rules, sequence-parallel encoding and
tensor-parallel serving over torch.distributed (port of
tpu_audio/parallel/: mesh, shardings, sp, and tp_quant's layout rules; its
`shard_map` is not ported: each rank serves its own shard, `tp_quant`)."""

from tpu_audio_torch.parallel.mesh import make_mesh
from tpu_audio_torch.parallel.shardings import (flow_rules, local_tree, param_shardings,
                                                shard_tree, transformer_rules,
                                                whisper_rules)

__all__ = ["make_mesh", "param_shardings", "shard_tree", "local_tree", "whisper_rules",
           "transformer_rules", "flow_rules"]
