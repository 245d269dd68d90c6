"""Checkpoint directories: a local path or a pre-seeded Hugging Face cache
(port of tpu_audio/utils/hub.py: snapshot, without its download branch).

`snapshot(repo_id)` resolves, in this order:
  1. a directory: returned as it is;
  2. a repo id whose snapshot sits in the cache, in the Hugging Face cache
     layout: `{cache}/models--{org}--{name}/refs/main` holds a revision and
     `{cache}/models--{org}--{name}/snapshots/{revision}/` its files. This
     is the directory `huggingface_hub.snapshot_download(repo_id,
     cache_dir=cache)` returns offline. The cache is $TPU_AUDIO_CACHE, by
     default ~/.cache/tpu_audio/hub, read at each call;
  3. anything else raises ModelLoadError naming the repo and the cache.
Nothing is downloaded.
"""

from __future__ import annotations

import os

from tpu_audio_torch.api.errors import ModelLoadError


def cache_root() -> str:
    return os.environ.get("TPU_AUDIO_CACHE",
                          os.path.join(os.path.expanduser("~"), ".cache", "tpu_audio", "hub"))


def repo_cache_dir(repo_id: str, root: str | None = None) -> str:
    """The cache folder of a repo id: {root}/models--{org}--{name}."""
    return os.path.join(root or cache_root(), "models--" + repo_id.replace("/", "--"))


def snapshot(repo_id: str) -> str:
    """repo_id (a directory or an HF repo id) → a local directory. A cached
    snapshot is returned whole, as the offline `snapshot_download` returns
    it."""
    if os.path.isdir(repo_id):
        return repo_id
    root = cache_root()
    repo_dir = repo_cache_dir(repo_id, root)
    ref = os.path.join(repo_dir, "refs", "main")
    if os.path.isfile(ref):
        with open(ref) as f:
            path = os.path.join(repo_dir, "snapshots", f.read().strip())
        if os.path.isdir(path):
            return path
    raise ModelLoadError(
        repo_id,
        f"no local directory and no snapshot in the cache {root}. Downloads are not "
        f"supported: pre-seed the cache (set TPU_AUDIO_CACHE) with "
        f"{repo_dir}/refs/main naming a revision and {repo_dir}/snapshots/<revision>/ "
        f"holding the files, or pass a local directory as the repo id")
