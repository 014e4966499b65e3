"""Model-asset acquisition (HF hub) and local manifest resolution.

A copy of `qwen3_tts_tpu/download.py` (the port keeps its own: importing
the JAX package imports JAX). The reference downloader's model layer: the
same HF repo (`cgisky/qwen3-tts-custom-gguf`), the per-quant manifest
(gguf / gguf_q5_k_m / gguf_q8_0), an hf-mirror.com fallback probe,
idempotent skip-if-exists downloads, chunked transfer with a progress
callback, `.part` resume (HTTP Range), bounded retries, and sha256
verification against a `checksums.json` sidecar when one is present.

Network access is optional: offline (`offline=True`, or
`QWEN3_TTS_OFFLINE=1`) `check_and_download` verifies what exists locally
and reports what is missing instead of fetching.
"""

from __future__ import annotations

import hashlib
import json
import os
import sys
import urllib.error
import urllib.request
from typing import Callable, Dict, List, Optional, Tuple

HF_BASE = "https://huggingface.co"
HF_MIRROR = "https://hf-mirror.com"
REPO = "cgisky/qwen3-tts-custom-gguf"
CHECKSUM_FILE = "checksums.json"

QUANT_DIRS = {
    "none": "gguf",
    "q5_k_m": "gguf_q5_k_m",
    "q8_0": "gguf_q8_0",
}


def quant_dir(quant: str) -> str:
    """Quant name -> repo/model subdirectory (src/download.rs:55-101)."""
    return QUANT_DIRS.get(quant, "gguf")


def manifest(quant: str = "none") -> List[Tuple[str, str]]:
    """(relative local path, repo path) pairs, per the reference manifest
    (src/download.rs:55-101)."""
    qdir = quant_dir(quant)
    return [
        ("onnx/qwen3_tts_decoder.onnx", "onnx/qwen3_tts_decoder.onnx"),
        ("tokenizer/tokenizer.json", "tokenizer/tokenizer.json"),
        (f"{qdir}/qwen3_assets.gguf", f"{qdir}/qwen3_assets.gguf"),
        (f"{qdir}/qwen3_tts_talker.gguf", f"{qdir}/qwen3_tts_talker.gguf"),
        (f"{qdir}/qwen3_tts_predictor.gguf", f"{qdir}/qwen3_tts_predictor.gguf"),
    ]


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _default_progress(rel: str, done: int, total: int) -> None:
    if total > 0:
        pct = 100.0 * done / total
        bar = "#" * int(pct / 5)
        sys.stderr.write(f"\r  {rel}: [{bar:<20}] {pct:5.1f}% "
                         f"({done >> 20}/{total >> 20} MiB)")
    else:
        sys.stderr.write(f"\r  {rel}: {done >> 20} MiB")
    if total and done >= total:
        sys.stderr.write("\n")
    sys.stderr.flush()


class Downloader:
    def __init__(self, offline: bool | None = None, timeout: float = 5.0,
                 retries: int = 2,
                 progress: Optional[Callable[[str, int, int], None]] = None):
        self.timeout = timeout
        self.retries = retries
        self.progress = _default_progress if progress is None else progress
        if offline is None:
            offline = os.environ.get("QWEN3_TTS_OFFLINE", "") == "1"
        self.offline = offline
        self.base = HF_BASE

    def _probe(self) -> None:
        """HF connectivity probe with mirror fallback
        (src/download.rs:17-38)."""
        for base in (HF_BASE, HF_MIRROR):
            try:
                req = urllib.request.Request(base, method="HEAD")
                urllib.request.urlopen(req, timeout=self.timeout)
                self.base = base
                return
            except (urllib.error.URLError, OSError):
                continue
        self.offline = True

    def missing(self, model_dir: str, quant: str = "none") -> List[str]:
        return [
            rel for rel, _ in manifest(quant)
            if not os.path.exists(os.path.join(model_dir, rel))
        ]

    def _checksums(self, model_dir: str) -> Dict[str, str]:
        path = os.path.join(model_dir, CHECKSUM_FILE)
        if not os.path.exists(path):
            return {}
        try:
            with open(path) as f:
                data = json.load(f)
            return {k: str(v) for k, v in data.items()}
        except (OSError, ValueError):
            return {}

    def _fetch(self, rel: str, url: str, local: str) -> str:
        """Streamed download with progress + `.part` Range resume."""
        os.makedirs(os.path.dirname(local), exist_ok=True)
        tmp = local + ".part"
        start = os.path.getsize(tmp) if os.path.exists(tmp) else 0
        headers = {"Range": f"bytes={start}-"} if start else {}
        req = urllib.request.Request(url, headers=headers)
        with urllib.request.urlopen(req, timeout=max(self.timeout, 30.0)) \
                as resp:
            if start and resp.status != 206:     # server ignored Range
                start = 0
            total = start + int(resp.headers.get("Content-Length") or 0)
            mode = "ab" if start else "wb"
            done = start
            with open(tmp, mode) as f:
                while True:
                    chunk = resp.read(1 << 20)
                    if not chunk:
                        break
                    f.write(chunk)
                    done += len(chunk)
                    self.progress(rel, done, total)
        os.replace(tmp, local)
        return "downloaded"

    def check_and_download(self, model_dir: str, quant: str = "none",
                           checksums: Optional[Dict[str, str]] = None
                           ) -> Dict[str, str]:
        """Fetch missing manifest entries (idempotent). Returns
        {relative path: status} with status in {exists, downloaded, missing,
        corrupt}. Files with a known sha256 (from the `checksums` arg or a
        `<model_dir>/checksums.json` sidecar) are verified; a bad existing
        file is re-fetched once before being reported corrupt."""
        sums = dict(self._checksums(model_dir))
        if checksums:
            sums.update(checksums)
        results: Dict[str, str] = {}
        todo = []
        for rel, repo_path in manifest(quant):
            local = os.path.join(model_dir, rel)
            if os.path.exists(local):
                if rel in sums and _sha256(local) != sums[rel]:
                    os.replace(local, local + ".corrupt")
                    todo.append((rel, repo_path, local))
                else:
                    results[rel] = "exists"
            else:
                todo.append((rel, repo_path, local))
        if not todo:
            return results
        if not self.offline:
            self._probe()
        for rel, repo_path, local in todo:
            if self.offline:
                results[rel] = "missing"
                continue
            url = f"{self.base}/{REPO}/resolve/main/{repo_path}"
            status = "missing"
            for attempt in range(self.retries + 1):
                try:
                    status = self._fetch(rel, url, local)
                    if rel in sums and _sha256(local) != sums[rel]:
                        os.replace(local, local + ".corrupt")
                        status = "corrupt"
                        continue            # retry a clean fetch
                    break
                except (urllib.error.URLError, OSError):
                    status = "missing"
            results[rel] = status
        return results
