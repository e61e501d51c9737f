from eabnet_tpu_torch.models.composed import EaBNetWithPostNet, build_model  # noqa: F401
from eabnet_tpu_torch.models.eabnet import EaBNet  # noqa: F401
from eabnet_tpu_torch.models.gagnet import GaGNet  # noqa: F401
