"""URL open with on-disk caching and retries (counterpart of
``pgx/utils/url.py``; the reference's ``dnnlib.util.open_url``).

Validates the URL, serves ``file://`` URLs and plain paths directly,
caches downloads under an md5-of-url key with an atomic rename (safe across
concurrent processes), retries transient failures with a short exponential
backoff, and returns a binary file object or the cached filename.  Plain
Python (``urllib``): nothing here touches torch.
"""

from __future__ import annotations

import hashlib
import io
import os
import re
import tempfile
import time
import urllib.parse
import urllib.request
import uuid
from typing import IO, Union


def is_url(obj: Union[str, os.PathLike], allow_file_urls: bool = False) -> bool:
    """Loose URL validation (dnnlib.util.is_url)."""
    if not isinstance(obj, str):
        return False
    if allow_file_urls and obj.startswith("file://"):
        return True
    try:
        res = urllib.parse.urlparse(obj)
        if res.scheme not in ("http", "https") or not res.netloc:
            return False
        body = urllib.parse.urlparse(res.netloc).path
        pat = r"^[-a-zA-Z0-9@:%._\+~#=]{1,256}(\.[a-zA-Z0-9()]{1,6})?(:\d+)?$"
        return re.match(pat, body) is not None
    except Exception:
        return False


def open_url(url: str, cache_dir: str = None, num_attempts: int = 10,
             verbose: bool = True, return_filename: bool = False,
             cache: bool = True) -> Union[IO[bytes], str]:
    """Open a URL as a binary file object, optionally caching the download.

    * plain paths and ``file://`` URLs bypass the network and the cache;
    * http(s) downloads are cached as ``<cache_dir>/<md5(url)>_<name>`` with
      a write-to-temp + atomic-replace commit;
    * transient errors retry up to ``num_attempts`` times.
    """
    assert num_attempts >= 1
    if not cache and return_filename and is_url(url):
        # reject up front: there would be no file to name
        raise ValueError("return_filename requires cache=True for URLs")

    if url.startswith("file://"):
        url = urllib.request.url2pathname(urllib.parse.urlparse(url).path)
    if not is_url(url):
        # local path passthrough (reference behavior for non-URLs)
        if return_filename:
            return url
        return open(url, "rb")

    if cache_dir is None:
        cache_dir = os.path.join(tempfile.gettempdir(), "pgx-torch-url-cache")
    url_md5 = hashlib.md5(url.encode("utf-8")).hexdigest()

    if cache:
        import glob as _glob
        hits = _glob.glob(os.path.join(cache_dir, url_md5 + "_*"))
        if hits:
            name = hits[0]
            return name if return_filename else open(name, "rb")

    data = None
    name = "download"
    for attempt in range(num_attempts):
        try:
            with urllib.request.urlopen(url) as resp:
                data = resp.read()
                cd = resp.headers.get("Content-Disposition", "")
                m = re.search(r'filename="?([^";]+)"?', cd)
                if m:
                    name = m.group(1)
                else:
                    tail = os.path.basename(
                        urllib.parse.urlparse(url).path)
                    name = tail or name
            break
        except (KeyboardInterrupt, SystemExit):
            raise
        except Exception:
            if attempt == num_attempts - 1:
                raise
            if verbose:
                print(".", end="", flush=True)
            time.sleep(min(0.1 * 2 ** attempt, 5.0))

    if cache:
        os.makedirs(cache_dir, exist_ok=True)
        safe = re.sub(r"[^0-9a-zA-Z-._]", "_", name)
        cache_file = os.path.join(cache_dir, f"{url_md5}_{safe}")
        tmp = os.path.join(cache_dir, f"tmp_{uuid.uuid4().hex}_{safe}")
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, cache_file)  # atomic; last concurrent writer wins
        if return_filename:
            return cache_file

    assert not return_filename
    return io.BytesIO(data)
