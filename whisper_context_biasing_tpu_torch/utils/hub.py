"""HuggingFace Hub sync (reference scripts/train.py:47-85 parity, gated).

A copy of the JAX package's ``utils/hub.py``: the reference syncs
checkpoints and results to the Hub on every save. These helpers keep that
workflow with the same signatures and return values, but degrade to no-ops
with a warning when ``huggingface_hub`` or network access is missing.
``huggingface_hub`` is imported inside each call, never at import.
"""

from __future__ import annotations

import os


def _api(token: str | None):
    try:
        from huggingface_hub import HfApi

        return HfApi(token=token)
    except Exception as e:
        print(f"[hub] unavailable ({e}); skipping")
        return None


def sync_from_hub(repo_id: str, local_dir: str, token: str | None = None) -> bool:
    """Download a model repo snapshot (reference sync_from_hub)."""
    try:
        from huggingface_hub import snapshot_download

        snapshot_download(repo_id=repo_id, local_dir=local_dir,
                          repo_type="model", token=token)
        return True
    except Exception as e:
        print(f"[hub] sync_from_hub skipped: {e}")
        return False


def upload_results_to_hub(results_file: str, repo_id: str, hub_path: str,
                          token: str | None = None) -> bool:
    """Upload one artifact file (reference upload_results_to_hub)."""
    if not os.path.isfile(results_file):
        raise FileNotFoundError(f"results file not found: {results_file}")
    api = _api(token)
    if api is None:
        return False
    try:
        api.upload_file(path_or_fileobj=results_file, path_in_repo=hub_path,
                        repo_id=repo_id, token=token)
        return True
    except Exception as e:
        print(f"[hub] upload skipped: {e}")
        return False


def push_to_hub_if_exists(local_dir: str, repo_id: str, token: str | None = None) -> bool:
    """Upload a checkpoint folder (reference push_to_hub_if_exists)."""
    if not (os.path.isdir(local_dir) and any(
        os.path.isfile(os.path.join(local_dir, f)) for f in os.listdir(local_dir)
    )):
        print(f"[hub] skipping upload: {local_dir} empty or missing")
        return False
    api = _api(token)
    if api is None:
        return False
    try:
        api.upload_folder(folder_path=local_dir, repo_id=repo_id,
                          repo_type="model", token=token)
        return True
    except Exception as e:
        print(f"[hub] upload skipped: {e}")
        return False
