"""Azure-aware data paths (capability parity with dpu_utils RichPath; a
copy of tf_gnn_samples_tpu/utils/paths.py, which the port does not import).

The reference upgrades every data path through `RichPath.create(path,
azure_info)` (reference train.py:61-72, test.py:33-39): a plain string is a
local path; `azure://ACCOUNT/CONTAINER/PREFIX` names a blob-storage prefix
that dpu_utils transparently downloads into a local cache on first read.

Equivalent here: rather than threading a path-like object through
every loader (they are hot host-side code), `localize_path` materializes an
azure:// prefix into a local cache directory ONCE, up front, and every
loader keeps operating on plain local paths. Auth comes from the same
azure_info JSON file dpu_utils uses:

    {"ACCOUNT": {"sas_token": "...", "cache_location": "/tmp/azcache"}}
    (or {"ACCOUNT": {"account_key": "..."}})

The Azure SDK import is lazy: the framework never requires it for local
data, and environments without `azure-storage-blob` get a clear error only
when an azure:// path is actually used.
"""

import json
import os
import re
from typing import Optional

_AZURE_RE = re.compile(r"^azure://([^/]+)/([^/]+)(?:/(.*))?$")


def is_azure_path(path: str) -> bool:
    return bool(path) and path.startswith("azure://")


def parse_azure_path(path: str):
    """azure://account/container[/prefix] -> (account, container, prefix)."""
    m = _AZURE_RE.match(path)
    if not m:
        raise ValueError(
            "Malformed azure path %r (want azure://ACCOUNT/CONTAINER/PREFIX)"
            % (path,)
        )
    return m.group(1), m.group(2), m.group(3) or ""


def _load_azure_info(azure_info_path: Optional[str], account: str):
    if not azure_info_path or not os.path.exists(azure_info_path):
        raise FileNotFoundError(
            "Azure auth file %r not found (needed for account %r); pass "
            "--azure-info pointing at a dpu_utils-style JSON."
            % (azure_info_path, account)
        )
    with open(azure_info_path, "rt") as f:
        info = json.load(f)
    if account not in info:
        raise KeyError(
            "Account %r not present in azure info file %s (has: %s)"
            % (account, azure_info_path, sorted(info))
        )
    return info[account]


def _default_container_client(account: str, container: str, auth):
    """Build an azure-storage-blob ContainerClient (lazy SDK import)."""
    try:
        from azure.storage.blob import ContainerClient
    except ImportError as e:  # pragma: no cover - env without the SDK
        raise RuntimeError(
            "azure:// data paths need the azure-storage-blob package, "
            "which is not installed in this environment."
        ) from e
    url = "https://%s.blob.core.windows.net" % account
    credential = auth.get("sas_token") or auth.get("account_key")
    return ContainerClient(url, container, credential=credential)


def localize_path(
    path: str,
    azure_info_path: Optional[str] = None,
    container_client_factory=_default_container_client,
) -> str:
    """Return a local path for `path`, downloading azure:// prefixes.

    Local paths pass through untouched. For azure:// paths, every blob
    under the prefix is downloaded into
    `<cache_location>/<account>/<container>/<prefix>` (cache_location from
    the auth entry, default ~/.azure_path_cache) unless an up-to-date copy
    already exists (size match — the dpu_utils cache heuristic).

    `container_client_factory(account, container, auth)` exists for tests:
    any object with `list_blobs(name_starts_with=...)` yielding objects
    with `.name`/`.size` and `download_blob(name)` with `.readall()` works.
    """
    if not is_azure_path(path):
        return path
    account, container, prefix = parse_azure_path(path)
    auth = _load_azure_info(azure_info_path, account)
    cache_root = auth.get(
        "cache_location", os.path.expanduser("~/.azure_path_cache")
    )
    local_root = os.path.join(cache_root, account, container, prefix)
    client = container_client_factory(account, container, auth)

    blobs = list(client.list_blobs(name_starts_with=prefix))
    if not blobs:
        raise FileNotFoundError("No blobs under %s" % path)
    n_fetched = 0
    for blob in blobs:
        rel = blob.name[len(prefix):].lstrip("/")
        local = os.path.join(local_root, rel) if rel else local_root
        size = getattr(blob, "size", None)
        if (os.path.exists(local) and size is not None
                and os.path.getsize(local) == size):
            continue
        os.makedirs(os.path.dirname(local) or ".", exist_ok=True)
        data = client.download_blob(blob.name).readall()
        with open(local, "wb") as f:
            f.write(data)
        n_fetched += 1
    print(
        " Localized %s -> %s (%d blobs, %d fetched)."
        % (path, local_root, len(blobs), n_fetched)
    )
    # A single-file prefix (e.g. azure://a/c/data/test.jsonl.gz) localizes
    # to that file; a directory prefix to the directory.
    if len(blobs) == 1 and blobs[0].name == prefix:
        return local_root
    return local_root
