from tcct_tpu_torch.models.registry import get_model, list_models
from tcct_tpu_torch.models.ftc import FTC, MPUpBlock
from tcct_tpu_torch.models.mpvit import MPViT, MPViTConfig
from tcct_tpu_torch.models.crosscnn import CrossResNet, CrossCNNBlock
from tcct_tpu_torch.models.regnet import RegNet
from tcct_tpu_torch.models.msca import MSCA
from tcct_tpu_torch.models.relaynet import ReLayNet
