"""Device meshes, parameter sharding rules and sequence-parallel encoding
over torch.distributed (port of tpu_audio/parallel/: mesh, shardings, sp;
`tp_quant` is not ported)."""

from tpu_audio_torch.parallel.mesh import make_mesh
from tpu_audio_torch.parallel.shardings import (flow_rules, param_shardings,
                                                shard_tree, transformer_rules,
                                                whisper_rules)

__all__ = ["make_mesh", "param_shardings", "shard_tree", "whisper_rules",
           "transformer_rules", "flow_rules"]
