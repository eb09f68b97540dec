from .registry import (create_model, model_config, model_names,  # noqa: F401
                       model_size, register_model)
from .resnet import (RESNET_CONFIGS, ResNet, ResNetConfig,  # noqa: F401
                     fold_batchnorm, is_folded)
from .rmac import (DescriptorConfig, RMACDescriptor, downsample_mask,  # noqa: F401
                   init_weights)
