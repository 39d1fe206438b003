"""Serving config (counterpart of ``analytics_zoo_tpu/serving/config.py``):
the one-shot serving fields, image payloads' ``input_dtype``, the health
file, the generative server's fields and the YAML schema of
``from_yaml``. The TensorBoard field is a later slice (ROADMAP Queue A
item 5); ``kv_shard`` parses, and ``GenerativeServing`` refuses values past
1 (item 7)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence


@dataclass
class ServingConfig:
    model_path: str = ""
    model_type: str = "zoo"  # only zoo models are ported so far
    data_src: str = "dir:///tmp/zoo_serving"
    image_shape: Sequence[int] = (224, 224, 3)
    input_dtype: str = "float32"  # "uint8" moves a quarter of the bytes to
    #   the card (pair with a model that normalizes on the device, e.g.
    #   resnet(preprocess="imagenet_uint8")); tensor records stay float32
    filter_top_n: Optional[int] = None
    batch_size: int = 4
    batch_wait_ms: int = 20  # micro-batch window
    max_pending: int = 10000  # erroring load-shed depth threshold
    concurrent_num: int = 1
    decode_threads: int = 4  # host threads decoding while the device runs
    quantize: Optional[str] = None  # bf16 | int8 (weight-only)
    # -- SLO layer ------------------------------------------------------------
    default_deadline_ms: Optional[int] = None  # for records that carry none
    shed_wait_ms: Optional[int] = None  # estimated-wait admission (None =
    #   depth-only shedding via max_pending)
    claim_retries: int = 20  # consecutive transient claim failures absorbed
    health_path: Optional[str] = None  # periodic + terminal health.json;
    #   metrics.prom is written beside it
    health_interval_s: float = 1.0  # min seconds between health writes
    # -- generative serving (continuous batching) -----------------------------
    slots: int = 8  # resident decode slots (the decode step's batch)
    max_new_tokens: int = 64  # a stream's budget when its request has none
    eos_id: Optional[int] = None  # stop token; None runs out the budget
    stream_interval: int = 1  # a partial result every N tokens
    temperature: Optional[float] = None  # any of the three set: sample
    top_k: Optional[int] = None          # through make_logit_filter; all
    top_p: Optional[float] = None        # None: greedy argmax
    # -- paged KV engine -------------------------------------------------------
    kv_pages: Optional[int] = None  # pool size in pages (page 0 the null
    #   page); None keeps a max_len rectangle a slot
    kv_page_len: int = 16  # tokens a page: a power of two <= 16 dividing
    #   the LM's max_len (so it divides every prefill bucket)
    kv_int8: bool = False  # int8 pool with delayed scaling
    kv_shard: int = 1  # devices the pool's pages spread over (item 7)
    spec_k: int = 0  # draft tokens a speculative round; 0 = off. Needs
    #   kv_pages and a draft_lm, greedy only

    @staticmethod
    def from_yaml(path: str) -> "ServingConfig":
        import yaml
        with open(path) as f:
            raw = yaml.safe_load(f) or {}
        model = raw.get("model", {}) or {}
        data = raw.get("data", {}) or {}
        params = raw.get("params", {}) or {}
        cfg = ServingConfig()
        cfg.model_path = model.get("path", cfg.model_path)
        cfg.model_type = model.get("type", cfg.model_type)
        cfg.data_src = data.get("src") or cfg.data_src
        cfg.input_dtype = data.get("input_dtype", cfg.input_dtype)
        if cfg.input_dtype not in ("float32", "uint8"):
            raise ValueError(f"input_dtype must be float32 or uint8, got "
                             f"{cfg.input_dtype!r}")
        if data.get("image_shape"):
            shape = data["image_shape"]
            if isinstance(shape, str):
                shape = [int(s) for s in shape.split(",")]
            cfg.image_shape = tuple(shape)
        if data.get("filter"):  # "topN(5)" like the reference
            s = str(data["filter"])
            if s.lower().startswith("topn"):
                cfg.filter_top_n = int(s[s.index("(") + 1:s.index(")")])
        cfg.batch_size = int(params.get("batch_size", cfg.batch_size))
        cfg.batch_wait_ms = int(params.get("batch_wait_ms",
                                           cfg.batch_wait_ms))
        cfg.max_pending = int(params.get("max_pending", cfg.max_pending))
        cfg.concurrent_num = int(params.get("concurrent_num",
                                            cfg.concurrent_num))
        cfg.decode_threads = int(params.get("decode_threads",
                                            cfg.decode_threads))
        cfg.quantize = params.get("quantize", cfg.quantize)
        if params.get("deadline_ms") is not None:
            cfg.default_deadline_ms = int(params["deadline_ms"])
        if params.get("shed_wait_ms") is not None:
            cfg.shed_wait_ms = int(params["shed_wait_ms"])
        cfg.claim_retries = int(params.get("claim_retries",
                                           cfg.claim_retries))
        cfg.slots = int(params.get("slots", cfg.slots))
        cfg.max_new_tokens = int(params.get("max_new_tokens",
                                            cfg.max_new_tokens))
        if params.get("eos_id") is not None:
            cfg.eos_id = int(params["eos_id"])
        cfg.stream_interval = int(params.get("stream_interval",
                                             cfg.stream_interval))
        if params.get("temperature") is not None:
            cfg.temperature = float(params["temperature"])
        if params.get("top_k") is not None:
            cfg.top_k = int(params["top_k"])
        if params.get("top_p") is not None:
            cfg.top_p = float(params["top_p"])
        if params.get("kv_pages") is not None:
            cfg.kv_pages = int(params["kv_pages"])
        cfg.kv_page_len = int(params.get("kv_page_len", cfg.kv_page_len))
        cfg.kv_int8 = bool(params.get("kv_int8", cfg.kv_int8))
        cfg.kv_shard = int(params.get("kv_shard", cfg.kv_shard))
        cfg.spec_k = int(params.get("spec_k", cfg.spec_k))
        cfg.health_path = raw.get("health_path", cfg.health_path)
        if raw.get("health_interval_s") is not None:
            cfg.health_interval_s = float(raw["health_interval_s"])
        return cfg
