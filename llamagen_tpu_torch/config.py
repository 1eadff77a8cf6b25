"""Model configurations of the port.

The model zoo and its dataclasses live in the JAX package's JAX-free
`llamagen_tpu.config` (one source for both packages); port code and
scripts import them from here.
"""

from llamagen_tpu.config import (GPTConfig, VQConfig, find_multiple,
                                 gpt_config, vq_config)

__all__ = ["GPTConfig", "VQConfig", "find_multiple", "gpt_config",
           "vq_config"]
