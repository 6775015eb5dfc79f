"""Config registry of the port: the model configs of every family (copies
of the reference's files), the assigned input shapes, the training config
and the scheduling configs."""
from repro_torch.configs.base import (INPUT_SHAPES, JobConfig, LoRAConfig,
                                      ModelConfig, MoEConfig, ShapeConfig,
                                      SSMConfig, ThroughputConfig,
                                      TrainConfig, shape_applicable)
from repro_torch.configs import (command_r_plus_104b, granite_20b,
                                 hubert_xlarge, llama2_7b, mamba2_370m,
                                 mixtral_8x7b, mixtral_8x22b, olmo_1b,
                                 qwen1_5_110b, qwen2_vl_7b, tiny_100m,
                                 zamba2_2_7b)

_MODULES = {
    "qwen2-vl-7b": qwen2_vl_7b,
    "olmo-1b": olmo_1b,
    "qwen1.5-110b": qwen1_5_110b,
    "granite-20b": granite_20b,
    "command-r-plus-104b": command_r_plus_104b,
    "llama2-7b": llama2_7b,
    "tiny-100m": tiny_100m,
    "mamba2-370m": mamba2_370m,
    "zamba2-2.7b": zamba2_2_7b,
    "mixtral-8x7b": mixtral_8x7b,
    "mixtral-8x22b": mixtral_8x22b,
    "hubert-xlarge": hubert_xlarge,
}


# the dry run's architectures (``--arch all``)
ASSIGNED_ARCHS = (
    "qwen2-vl-7b",
    "mamba2-370m",
    "olmo-1b",
    "zamba2-2.7b",
    "qwen1.5-110b",
    "mixtral-8x7b",
    "mixtral-8x22b",
    "granite-20b",
    "command-r-plus-104b",
    "hubert-xlarge",
)


def list_archs():
    return list(_MODULES)


def get_config(name: str) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(_MODULES)}")
    return _MODULES[name].config()


def get_smoke_config(name: str) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(_MODULES)}")
    return _MODULES[name].smoke_config()


__all__ = ["ASSIGNED_ARCHS", "INPUT_SHAPES", "JobConfig", "LoRAConfig",
           "ModelConfig", "MoEConfig", "SSMConfig", "ShapeConfig",
           "ThroughputConfig", "TrainConfig", "get_config", "get_smoke_config",
           "list_archs", "shape_applicable"]
