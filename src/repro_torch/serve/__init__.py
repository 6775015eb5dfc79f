from repro_torch.serve.engine import Request, ServingEngine

__all__ = ["Request", "ServingEngine"]
