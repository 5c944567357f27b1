"""Default configuration tree (the PyTorch port's own copy of
uvltrack_tpu/config/defaults.py, key for key, so both packages read the same
experiments/uvltrack/*.yaml).

Key names/values mirror the reference defaults (lib/config/uvltrack/config.py:7-147)
so that experiment YAMLs written for the reference parse unchanged. Runtime
knobs live under cfg.TPU; the port reads COMPUTE_DTYPE, CACHE_TEXT,
USE_PALLAS_ATTENTION (True selects the hand-written CUDA attention kernel,
ops/attention.py), WEIGHT_QUANT, REMAT, GRAD_ACCUM and LOADER_WORKER_MODE
(thread or process workers of data/loader.py, TRAIN.NUM_WORKER of them),
and ignores the mesh and compile-cache keys.
"""

from __future__ import annotations

from .cfgnode import CfgNode


def default_cfg() -> CfgNode:
    c = CfgNode()

    # ------------------------------------------------------------------ MODEL
    c.MODEL = CfgNode()
    c.MODEL.HIDDEN_DIM = 384
    c.MODEL.NUM_OBJECT_QUERIES = 1
    c.MODEL.POSITION_EMBEDDING = "sine"
    c.MODEL.PREDICT_MASK = False
    c.MODEL.LEARNABLE_POSITION = False

    c.MODEL.BACKBONE = CfgNode()
    c.MODEL.BACKBONE.TYPE = "mae_vit"
    c.MODEL.BACKBONE.DROP_PATH_RATE = 0.0
    c.MODEL.BACKBONE.PRETRAINED_PATH = ""
    c.MODEL.BACKBONE.FUSION_LAYER = [8, 9, 10, 11]
    c.MODEL.BACKBONE.CONT_LOSS_LAYER = [4, 5, 6, 7, 8, 9, 10, 11]
    c.MODEL.BACKBONE.TXT_TOKEN_MODE = "token"

    c.MODEL.BACKBONE.LANGUAGE = CfgNode()
    c.MODEL.BACKBONE.LANGUAGE.IMPLEMENT = "jax"
    c.MODEL.BACKBONE.LANGUAGE.TYPE = "bert-base-uncased"
    c.MODEL.BACKBONE.LANGUAGE.PATH = "pretrained/bert/bert-base-uncased.tar.gz"
    c.MODEL.BACKBONE.LANGUAGE.VOCAB_PATH = "pretrained/bert/bert-base-uncased-vocab.txt"
    c.MODEL.BACKBONE.LANGUAGE.BERT = CfgNode()
    c.MODEL.BACKBONE.LANGUAGE.BERT.LR = 10e-5
    c.MODEL.BACKBONE.LANGUAGE.BERT.ENC_NUM = 12
    c.MODEL.BACKBONE.LANGUAGE.BERT.HIDDEN_DIM = 256
    c.MODEL.BACKBONE.LANGUAGE.BERT.MAX_QUERY_LEN = 40

    c.MODEL.HEAD = CfgNode()
    c.MODEL.HEAD.TYPE = "anchor_free"
    c.MODEL.HEAD.HEAD_DIM = 384
    c.MODEL.HEAD.CLS_TOKENIZE = True
    c.MODEL.HEAD.OFFSET_SIGMOID = True
    c.MODEL.HEAD.JOINT_CLS = False
    c.MODEL.HEAD.DROP = 0.0
    c.MODEL.HEAD.SOFTMAX_ONE = False
    c.MODEL.HEAD.GROUNDING_DILATION = 1
    c.MODEL.HEAD.CONTRASTIVE_CONV = False

    # ------------------------------------------------------------------ TRAIN
    c.TRAIN = CfgNode()
    c.TRAIN.POSITIVE_MODE = "ctr"
    c.TRAIN.MODE = "grounding"
    c.TRAIN.VLTVG_AUG = False  # dead in the reference too (defined config.py:53, never read); the grounding2 aug chain is unconditional in both
    c.TRAIN.GROUNDING_RATIO = None
    c.TRAIN.VL_RATIO = None
    c.TRAIN.LR = 0.0001
    c.TRAIN.WEIGHT_DECAY = 0.0001
    c.TRAIN.EPOCH = 500
    c.TRAIN.LR_DROP_EPOCH = 400
    c.TRAIN.BATCH_SIZE = 16
    c.TRAIN.NUM_WORKER = 8
    c.TRAIN.OPTIMIZER = "ADAMW"
    c.TRAIN.BACKBONE_MULTIPLIER = 0.1
    c.TRAIN.GIOU_WEIGHT = 2.0
    c.TRAIN.L1_WEIGHT = 5.0
    c.TRAIN.AUX_WEIGHT = 0.0
    c.TRAIN.CONT_WEIGHT = 1.0
    c.TRAIN.CIB_WEIGHT = 0.01
    c.TRAIN.CTR_RATIO = 0.75
    c.TRAIN.DEEP_SUPERVISION = False
    c.TRAIN.FREEZE_STAGE0 = False
    c.TRAIN.PRINT_INTERVAL = 50
    c.TRAIN.VAL_EPOCH_INTERVAL = 20
    c.TRAIN.GRAD_CLIP_NORM = 0.1
    c.TRAIN.DYNAMIC_CLS = False
    c.TRAIN.REDUCTION = "sum"
    c.TRAIN.GAUSSIAN_IOU = 0.3
    c.TRAIN.SCHEDULER = CfgNode()
    c.TRAIN.SCHEDULER.TYPE = "step"
    c.TRAIN.SCHEDULER.DECAY_RATE = 0.1
    c.TRAIN.SCHEDULER.WARM_EPOCH = 30
    c.TRAIN.SCHEDULER.MILESTONES = [200, 250, 290]
    c.TRAIN.SCHEDULER.GAMMA = 0.1

    # ------------------------------------------------------------------- DATA
    c.DATA = CfgNode()
    c.DATA.CONTEXT_GAP = None
    c.DATA.MEAN = [0.485, 0.456, 0.406]
    c.DATA.STD = [0.229, 0.224, 0.225]
    c.DATA.MAX_SAMPLE_INTERVAL = 200
    c.DATA.TRAIN = CfgNode()
    c.DATA.TRAIN.DATASETS_NAME = ["GOT10K_vottrain"]
    c.DATA.TRAIN.DATASETS_RATIO = [1]
    c.DATA.TRAIN.SAMPLE_PER_EPOCH = 60000
    c.DATA.VAL = CfgNode()
    c.DATA.VAL.DATASETS_NAME = ["GOT10K_votval"]
    c.DATA.VAL.DATASETS_RATIO = [1]
    c.DATA.VAL.SAMPLE_PER_EPOCH = 10000
    c.DATA.VALTRACK = CfgNode()
    c.DATA.VALTRACK.DATASETS_NAME = ["OTB99_test"]
    c.DATA.VALTRACK.DATASETS_RATIO = [1]
    c.DATA.VALTRACK.SAMPLE_PER_EPOCH = 10000
    c.DATA.VALVL = CfgNode()
    c.DATA.VALVL.DATASETS_NAME = ["OTB99_test"]
    c.DATA.VALVL.DATASETS_RATIO = [1]
    c.DATA.VALVL.SAMPLE_PER_EPOCH = 10000
    c.DATA.SEARCH = CfgNode()
    c.DATA.SEARCH.SIZE = 320
    c.DATA.SEARCH.FACTOR = 5.0
    c.DATA.SEARCH.NUMBER = 1
    c.DATA.SEARCH.CENTER_JITTER = 4.5
    c.DATA.SEARCH.SCALE_JITTER = 0.5
    c.DATA.SEARCH.CENTER_JITTER_GROUNDING = 4.5
    c.DATA.SEARCH.SCALE_JITTER_GROUNDING = 0.5
    c.DATA.TEMPLATE = CfgNode()
    c.DATA.TEMPLATE.SIZE = 128
    c.DATA.TEMPLATE.FACTOR = 2.0
    c.DATA.TEMPLATE.NUMBER = 1
    c.DATA.TEMPLATE.CENTER_JITTER = 0
    c.DATA.TEMPLATE.SCALE_JITTER = 0

    # ------------------------------------------------------------------- TEST
    c.TEST = CfgNode()
    c.TEST.MODE = "NL"
    c.TEST.TEMPLATE_FACTOR = 2.0
    c.TEST.TEMPLATE_SIZE = 128
    c.TEST.SEARCH_FACTOR = 5.0
    c.TEST.SEARCH_SIZE = 320
    c.TEST.EPOCH = 500
    c.TEST.THRESHOLD = 0.5
    c.TEST.THRESHOLD_CONT = 0.0
    c.TEST.THRESHOLD_CLS = 0.0
    c.TEST.WINDOW_INFLUENCE = 0.49
    c.TEST.UPDATE_INTERVAL = 100000
    # per-dataset interval table — defined by the reference config
    # (config.py:142-147) but unused by its live tracker; kept so strict
    # YAML merge accepts configs that set it
    c.TEST.UPDATE_INTERVALS = CfgNode()
    c.TEST.UPDATE_INTERVALS.LASOT = [200]
    c.TEST.UPDATE_INTERVALS.GOT10K_TEST = [200]
    c.TEST.UPDATE_INTERVALS.TRACKINGNET = [200]
    c.TEST.UPDATE_INTERVALS.VOT20 = [200]
    c.TEST.UPDATE_INTERVALS.VOT20LT = [200]

    # -------------------------------------------------------------------- TPU
    # TPU-native knobs (no reference equivalent).
    c.TPU = CfgNode()
    c.TPU.COMPUTE_DTYPE = "bfloat16"  # matmul/attention compute dtype
    c.TPU.PARAM_DTYPE = "float32"
    c.TPU.USE_PALLAS_ATTENTION = True
    c.TPU.MESH_DATA = -1  # -1: all devices on the data axis
    c.TPU.ZERO1 = False  # shard Adam moments over the data axis (ZeRO-1)
    c.TPU.MESH_MODEL = 1
    c.TPU.REMAT = False  # jax.checkpoint the backbone blocks during training
    # >1: accumulate gradients over k microbatches (lax.scan inside the
    # jitted step) — activation memory scales with BATCH_SIZE/k while the
    # optimizer sees the full effective batch. BATCH_SIZE must divide by k.
    c.TPU.GRAD_ACCUM = 1
    c.TPU.COMPILE_CACHE = ""  # persistent XLA compile cache dir ("" = off)
    # Compute the pre-fusion BERT text stream once per sequence at tracker
    # init instead of every frame (identical math; saves ~85 MB of bf16
    # weight reads per frame at bs=1 ViT-B — see MUFE.encode_text).
    c.TPU.CACHE_TEXT = True
    # "" | "int8": weight-only symmetric per-channel quantization of the
    # ViT matmul kernels at inference build (ops/quant.py). bs=1 tracking
    # is weight-read bound, so int8 halves the dominant HBM stream.
    # Opt-in until chip-measured (bench: UVLTRACK_BENCH_QUANT=int8).
    c.TPU.WEIGHT_QUANT = ""
    # "thread" | "process": loader worker pool kind. Threads are zero-copy
    # (enough when cv2 dominates); processes give true parallelism for the
    # numpy/Python stages like the reference's NUM_WORKER dataloader procs.
    c.TPU.LOADER_WORKER_MODE = "thread"

    return c


def load_cfg(yaml_file: str | None = None) -> CfgNode:
    cfg = default_cfg()
    if yaml_file:
        cfg.merge_from_file(yaml_file)
    return cfg
