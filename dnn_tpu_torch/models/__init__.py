# Importing the model modules registers them with the model registry.
from dnn_tpu_torch.models import cifar  # noqa: F401
from dnn_tpu_torch.models import gpt  # noqa: F401
from dnn_tpu_torch.models import llama  # noqa: F401
from dnn_tpu_torch.models import mlp  # noqa: F401
