from .bert import BertConfig, BertEmbeddings, BertLayer
from .head import MABH, DistributionPrompter
from .mufe import MUFE
from .uvltrack import UVLTrack, build_model, init_model
from .vit import PatchEmbed, VitBlock

__all__ = [
    "BertConfig", "BertEmbeddings", "BertLayer", "MABH",
    "DistributionPrompter", "MUFE", "UVLTrack", "build_model", "init_model",
    "PatchEmbed", "VitBlock",
]
