"""Input data of the port's train paths: synthetic LM batches, the
streaming pipeline (shard source, checksum-verified shard cache,
background prefetch) and GNMT's bucketization (``repro.data``)."""
from repro_torch.data import bucketization, cache, pipeline, prefetch, source
from repro_torch.data.cache import (
    CacheCorruptError,
    CacheError,
    CacheMismatchError,
    CacheStatus,
    ShardCache,
    check_cache,
)
from repro_torch.data.pipeline import Pipeline
from repro_torch.data.prefetch import Prefetcher
from repro_torch.data.source import Source, SyntheticShardSource

__all__ = [
    "bucketization",
    "cache",
    "pipeline",
    "prefetch",
    "source",
    "CacheCorruptError",
    "CacheError",
    "CacheMismatchError",
    "CacheStatus",
    "ShardCache",
    "check_cache",
    "Pipeline",
    "Prefetcher",
    "Source",
    "SyntheticShardSource",
]
