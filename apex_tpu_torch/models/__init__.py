"""Models of the port."""
from apex_tpu_torch.models.bert import (  # noqa: F401
    BertConfig,
    BertEncoder,
    BertForMLM,
    BertLayer,
    init_bert_params,
)
from apex_tpu_torch.models.dcgan import (  # noqa: F401
    Discriminator,
    Generator,
    init_dcgan_params,
)
from apex_tpu_torch.models.gpt import (  # noqa: F401
    GPTConfig,
    GPTLayer,
    GPTLM,
    init_params,
)
from apex_tpu_torch.models.resnet import (  # noqa: F401
    Bottleneck,
    ResNet,
    SpaceToDepthStem,
    init_resnet_params,
    resnet50,
    resnet101,
    resnet152,
)

__all__ = ["BertConfig", "BertEncoder", "BertForMLM", "BertLayer",
           "Bottleneck", "Discriminator", "GPTConfig", "GPTLayer", "GPTLM",
           "Generator", "ResNet", "SpaceToDepthStem", "init_bert_params",
           "init_dcgan_params", "init_params", "init_resnet_params",
           "resnet101", "resnet152", "resnet50"]
