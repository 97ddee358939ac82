"""Model registry: the JAX package's twelve families."""

from __future__ import annotations

from typing import Mapping, Optional, Tuple

from pytorch_news_recommender_tpu_torch.config import ModelConfig
from pytorch_news_recommender_tpu_torch.models.common import RecModel
from pytorch_news_recommender_tpu_torch.models.disan import DiSANRec
from pytorch_news_recommender_tpu_torch.models.fastformer import Fastformer
from pytorch_news_recommender_tpu_torch.models.gnn import GNNRec
from pytorch_news_recommender_tpu_torch.models.hierec import HieRec
from pytorch_news_recommender_tpu_torch.models.list_rank import ListRank
from pytorch_news_recommender_tpu_torch.models.lstur import LSTUR
from pytorch_news_recommender_tpu_torch.models.naml import NAML
from pytorch_news_recommender_tpu_torch.models.npa import NPA
from pytorch_news_recommender_tpu_torch.models.nrms import NRMS
from pytorch_news_recommender_tpu_torch.models.nrms_bert import NRMSBert
from pytorch_news_recommender_tpu_torch.models.nrms_entity import NRMSEntity
from pytorch_news_recommender_tpu_torch.models.tanr import TANR

_REGISTRY = {"nrms": NRMS, "nrms_entity": NRMSEntity, "tanr": TANR, "hierec": HieRec,
             "naml": NAML, "nrms_bert": NRMSBert, "disan": DiSANRec, "lstur": LSTUR,
             "list_rank": ListRank, "npa": NPA, "fastformer": Fastformer, "gnn": GNNRec}


def available_models() -> list[str]:
    return sorted(_REGISTRY)


def build_model(cfg: ModelConfig,
                feat_shapes: Optional[Mapping[str, Tuple[int, ...]]] = None) -> RecModel:
    """The family ``cfg.name`` with uninitialized parameters (call
    ``reset_parameters(generator)`` or load a state dict). ``feat_shapes``
    gives the shapes of the dataset's feature tables, which ``nrms_bert``'s
    table and ``list_rank``'s news tower take."""
    name = cfg.name.lower()
    if name not in _REGISTRY:
        raise KeyError(f"unknown model family {cfg.name!r}; "
                         f"available: {available_models()}")
    return _REGISTRY[name].from_config(cfg, feat_shapes)
