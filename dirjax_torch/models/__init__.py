from .registry import (create_model, is_vit, model_config, model_names,  # noqa: F401
                       model_size, register_model)
from .resnet import (RESNET_CONFIGS, ResNet, ResNetConfig,  # noqa: F401
                     fold_batchnorm, is_folded)
from .rmac import (DescriptorConfig, RMACDescriptor, ViTDescriptor,  # noqa: F401
                   ViTDescriptorConfig, downsample_mask, init_weights)
from .vit import VIT_CONFIGS, ViTConfig, VisionTransformer  # noqa: F401
