from tpuclip_torch.models.configs import (  # noqa: F401
    PRESETS,
    SiglipConfig,
    TextConfig,
    VisionConfig,
    get_config,
)
from tpuclip_torch.models.siglip import SiglipModel  # noqa: F401
