"""Models of the port."""
from apex_tpu_torch.models.bert import (  # noqa: F401
    BertConfig,
    BertEncoder,
    BertForMLM,
    BertLayer,
    init_bert_params,
)
from apex_tpu_torch.models.gpt import (  # noqa: F401
    GPTConfig,
    GPTLayer,
    GPTLM,
    init_params,
)

__all__ = ["BertConfig", "BertEncoder", "BertForMLM", "BertLayer",
           "GPTConfig", "GPTLayer", "GPTLM", "init_bert_params",
           "init_params"]
