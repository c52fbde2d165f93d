"""The host data pipeline and the on-device preprocessing.

Nothing imported here needs PIL, pyarrow or transformers: the modules that
use them import them inside the functions that need them."""

from fiber_torch.data.mlm import mlm_mask  # noqa: F401
from fiber_torch.data.transforms import (normalize_on_device,  # noqa: F401
                                         IMAGENET_INCEPTION_MEAN,
                                         IMAGENET_INCEPTION_STD)
