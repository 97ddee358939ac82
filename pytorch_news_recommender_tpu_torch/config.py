"""Typed, serializable configuration (the port's own copy).

Field for field the same dataclasses as the JAX package's ``config.py``, so a
``config.json`` written there loads here unchanged and the other way round.
Fields that only the JAX package's training, sharding or Pallas paths read
are kept for file compatibility; the port reads what its ported modules use.
``use_pallas`` is one of them: on a CUDA device the hand-written kernel
always runs, and on the CPU the plain PyTorch version does.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
from typing import Any, Optional


def _asdict(obj: Any) -> Any:
    if dataclasses.is_dataclass(obj):
        return {f.name: _asdict(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    return obj


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Dataset layout and fixed batch geometry: title 20 words, abstract 40,
    history 50 clicked news, 1 positive + ``sample_size`` negatives per
    training impression, eval candidate lists capped at
    ``max_candidate_size``."""

    dataset: str = "demo"               # demo | small | large | synthetic
    data_dir: str = "data_processed"
    n_words_title: int = 20
    n_words_abst: int = 40
    history_len: int = 50
    sample_size: int = 5                # negatives per positive
    max_candidate_size: int = 300       # eval candidate cap
    min_history: int = 5                # drop train users with shorter history
    word_freq_threshold: int = 3
    entity_nums: int = 10
    eval_buckets: tuple[int, ...] = (8, 16, 32, 64, 128, 300)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Model-family hyperparameters. Sizes that depend on preprocessing
    artifacts (``n_words``, ``category_nums``, ...) are filled in from
    :class:`ArtifactMeta` via :meth:`with_artifact_meta`."""

    name: str = "nrms"
    # artifact-derived (0 means "must be set from artifact metadata")
    n_words: int = 0
    n_news: int = 0
    category_nums: int = 0
    subcategory_nums: int = 0
    entity_nums: int = 0
    n_users: int = 0
    # embedding dims
    word_embed_size: int = 300
    cate_embed_size: int = 100
    bert_embed_size: int = 512
    entity_embed_size: int = 100
    # attention dims
    num_attention_heads: int = 10       # word-level MHSA heads (300 % 10 == 0)
    user_heads_num: int = 10            # user-encoder MHSA heads
    query_vector_dim: int = 200         # additive-attention projection
    query_vector_dim_large: int = 400
    # NAML / LSTUR CNN tower
    num_filters: int = 400
    kernel_size: int = 3
    # list_rank re-ranker
    list_num_heads: int = 8
    list_ff_dim: int = 512
    list_layers: int = 1
    list_title_size: int = 512
    # nrms_bert
    bert_trainable: bool = True
    freeze_word_embeddings: bool = False
    # lstur
    long_short_term_method: str = "ini"  # 'ini' | 'con'
    # disan
    disan_hidden: int = 0               # 0 -> word_embed_size
    # fastformer
    fastformer_layers: int = 1
    # npa: personalized-attention query dim; 0 -> query_vector_dim // 2
    npa_query_dim: int = 0
    # tanr
    topic_loss_weight: float = 0.2
    # hierec
    n_interests: int = 8
    # gnn
    gnn_layers: int = 2
    gnn_neighbors: int = 15
    dropout: float = 0.2
    # length-bucketed unique-news encoding (training); 0 disables
    short_title_len: int = 12
    short_abst_len: int = 0
    # sharded embedding-lookup schedule: auto | psum | a2a (JAX mesh training)
    embedding_lookup: str = "auto"
    a2a_capacity_factor: float = 2.0
    # numerics
    compute_dtype: str = "bfloat16"     # activations/matmul inputs
    param_dtype: str = "float32"        # parameters + accumulations
    use_pallas: bool = True             # kept for file compatibility
    pallas_interpret: bool = False      # kept for file compatibility
    dedup_gather_mxu: bool = False

    def with_artifact_meta(self, meta: "ArtifactMeta") -> "ModelConfig":
        return dataclasses.replace(
            self,
            n_words=meta.n_words,
            n_news=meta.n_news,
            category_nums=meta.category_nums,
            subcategory_nums=meta.subcategory_nums,
            entity_nums=meta.entity_nums,
            n_users=meta.n_users,
        )


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Optimization schedule (Adam lr=1e-3, batch 512, optional 500-step
    linear warm-up, eval every 5000 steps). Serving reads only
    ``eval_encode_chunk``: the corpus encode runs in chunks of that many
    news."""

    batch_size: int = 512
    eval_batch_size: int = 128
    learning_rate: float = 1e-3
    num_epochs: int = 6
    eval_step: int = 5000
    log_every: int = 100
    warm_up: bool = False
    warm_up_steps: int = 500
    weight_decay: float = 0.0
    grad_clip_norm: float = 0.0         # 0 = off
    optimizer: str = "adam"
    grad_accum_steps: int = 1
    seed: int = 422
    dedup_batches: bool = True
    unique_buckets: Optional[tuple[int, ...]] = None
    gnn_frontier_buckets: Optional[tuple[int, ...]] = None
    eval_two_tower: bool = True
    eval_encode_chunk: int = 4096
    auc_checkpoint_floor: float = 0.56  # min dev AUC before checkpointing
    max_dev_samples: int = 100_000
    require_improvement: int = 0
    debug_nans: bool = False
    skip_nonfinite_updates: bool = False
    auto_layouts: bool = False
    sliced_feed: bool = False
    save_dir: str = "save_model"
    log_dir: str = "logs"


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Device-mesh layout: ``data`` is the batch axis, ``model`` row-shards
    the large embedding tables."""

    data_axis: str = "data"
    model_axis: str = "model"
    model_parallel_size: int = 1        # 1 = pure data parallel

    def mesh_shape(self, n_devices: int) -> tuple[int, int]:
        """``(n_data, n_model)`` for ``n_devices`` devices or processes."""
        mp = max(1, self.model_parallel_size)
        if n_devices % mp != 0:
            raise ValueError(
                f"n_devices={n_devices} not divisible by model_parallel_size={mp}"
            )
        return (n_devices // mp, mp)


@dataclasses.dataclass(frozen=True)
class Config:
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)
    description: str = ""

    # ---- serialization ----
    def to_dict(self) -> dict:
        return _asdict(self)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2)

    @classmethod
    def from_dict(cls, d: dict) -> "Config":
        def build(tp, sub):
            fields = {f.name: f for f in dataclasses.fields(tp)}
            kwargs = {}
            for k, v in sub.items():
                if k not in fields:
                    continue
                if isinstance(v, list):
                    v = tuple(v)
                kwargs[k] = v
            return tp(**kwargs)

        return cls(
            data=build(DataConfig, d.get("data", {})),
            model=build(ModelConfig, d.get("model", {})),
            train=build(TrainConfig, d.get("train", {})),
            mesh=build(MeshConfig, d.get("mesh", {})),
            description=d.get("description", ""),
        )

    @classmethod
    def from_json(cls, s: str) -> "Config":
        return cls.from_dict(json.loads(s))

    def save(self, path: str | pathlib.Path) -> None:
        pathlib.Path(path).write_text(self.to_json())

    @classmethod
    def load(cls, path: str | pathlib.Path) -> "Config":
        return cls.from_json(pathlib.Path(path).read_text())


@dataclasses.dataclass(frozen=True)
class ArtifactMeta:
    """Sizes derived from preprocessing output, written next to the arrays
    and consumed by :meth:`ModelConfig.with_artifact_meta`."""

    n_words: int
    n_news: int
    category_nums: int
    subcategory_nums: int
    entity_nums: int = 0
    n_users: int = 0
    n_train_samples: int = 0
    n_dev_impressions: int = 0
    n_test_impressions: int = 0

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @classmethod
    def from_json(cls, s: str) -> "ArtifactMeta":
        d = json.loads(s)
        return cls(**{f.name: d[f.name] for f in dataclasses.fields(cls) if f.name in d})

    def save(self, path: str | pathlib.Path) -> None:
        pathlib.Path(path).write_text(self.to_json())

    @classmethod
    def load(cls, path: str | pathlib.Path) -> "ArtifactMeta":
        return cls.from_json(pathlib.Path(path).read_text())


# ---- presets -------------------------------------------------------------

def large_config() -> Config:
    """MIND-large configuration."""
    return Config(
        data=DataConfig(dataset="large"),
        train=TrainConfig(batch_size=512, num_epochs=6),
    )


def synthetic_config(**overrides) -> Config:
    """Tiny synthetic-data configuration used by tests; ``overrides`` take
    ``"section.field"`` keys."""
    data = DataConfig(dataset="synthetic", eval_buckets=(8, 16, 32))
    model = ModelConfig(
        num_attention_heads=4,
        user_heads_num=4,
        word_embed_size=64,
        query_vector_dim=32,
        query_vector_dim_large=48,
        cate_embed_size=16,
        bert_embed_size=64,
        entity_embed_size=16,
        num_filters=32,
        list_ff_dim=64,
        list_num_heads=4,
        list_title_size=64,
        compute_dtype="float32",
        use_pallas=False,
    )
    train = TrainConfig(batch_size=32, eval_batch_size=32, num_epochs=1,
                        eval_step=10_000, max_dev_samples=10_000)
    cfg = Config(data=data, model=model, train=train)
    if overrides:
        d = cfg.to_dict()
        for k, v in overrides.items():
            section, _, field = k.partition(".")
            if field:
                d[section][field] = v
            else:
                d[k] = v
        cfg = Config.from_dict(d)
    return cfg


# Per-family training defaults, applied where the family is chosen (``cli
# train``), never inside the Trainer, so an explicit Config is taken as it
# is: the JAX package's ``FAMILY_TRAIN_DEFAULTS`` (its npa learning rate from
# ``benchmarks/npa_sweep.py``, fastformer's from a 3-epoch probe).
FAMILY_TRAIN_DEFAULTS: dict = {
    "npa": {"learning_rate": 2e-2},
    "fastformer": {"learning_rate": 1e-2},
}


def apply_family_defaults(d: dict, explicit: set = frozenset()) -> dict:
    """Overlays ``FAMILY_TRAIN_DEFAULTS[model.name]`` onto the config dict
    ``d``, skipping the train fields named in ``explicit`` (flags the user
    passed win)."""
    for field, value in FAMILY_TRAIN_DEFAULTS.get(
            d.get("model", {}).get("name", ""), {}).items():
        if field not in explicit:
            d["train"][field] = value
    return d
