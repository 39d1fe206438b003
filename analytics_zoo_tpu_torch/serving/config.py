"""Serving config (counterpart of ``analytics_zoo_tpu/serving/config.py``):
the one-shot serving fields and the YAML schema of ``from_yaml``. Image
payloads (``input_dtype``), the generative, brownout and health-file fields
are later slices."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence


@dataclass
class ServingConfig:
    model_path: str = ""
    model_type: str = "zoo"  # only zoo models are ported so far
    data_src: str = "dir:///tmp/zoo_serving"
    image_shape: Sequence[int] = (224, 224, 3)
    filter_top_n: Optional[int] = None
    batch_size: int = 4
    batch_wait_ms: int = 20  # micro-batch window
    max_pending: int = 10000  # erroring load-shed depth threshold
    concurrent_num: int = 1
    decode_threads: int = 4  # host threads decoding while the device runs
    # -- SLO layer ------------------------------------------------------------
    default_deadline_ms: Optional[int] = None  # for records that carry none
    shed_wait_ms: Optional[int] = None  # estimated-wait admission (None =
    #   depth-only shedding via max_pending)
    claim_retries: int = 20  # consecutive transient claim failures absorbed

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
        if params.get("deadline_ms") is not None:
            cfg.default_deadline_ms = int(params["deadline_ms"])
        if params.get("shed_wait_ms") is not None:
            cfg.shed_wait_ms = int(params["shed_wait_ms"])
        cfg.claim_retries = int(params.get("claim_retries",
                                           cfg.claim_retries))
        return cfg
