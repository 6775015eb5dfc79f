"""Tree utilities over the port's parameters (dicts, per-layer lists)."""
from repro_torch.utils.partition import (is_lora_path, partition_by_path,
                                         select_paths)
from repro_torch.utils.tree import (count_params, flatten, flatten_with_path,
                                    tree_bytes, tree_map_with_path_names,
                                    unflatten)

__all__ = ["count_params", "flatten", "flatten_with_path", "is_lora_path",
           "partition_by_path", "select_paths", "tree_bytes",
           "tree_map_with_path_names", "unflatten"]
