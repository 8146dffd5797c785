from wmfml_tpu_torch.configs.config import (Config, TASK_SHAPES, resolve_device,
                                            torch_dtype)

__all__ = ["Config", "TASK_SHAPES", "resolve_device", "torch_dtype"]
