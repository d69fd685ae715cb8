"""Webdataset-style tar shards: streaming, decoding, filtering and batches of
pre-encoded samples.

The port's own copy of the jax-free pieces of
``open_muse_tpu/training/data.py``: brace expansion, (``pipe:``) tar
streaming with key grouping that skips corrupt members, the per-process shard
split (the rank and the process count are given, never looked up), sample
decoding, the resize-and-crop image transform, the dataset dialects'
raw-sample maps (``DATASET_MAPS``), the metadata quality filter and a
background prefetch thread.  ``PreEncodedDataset`` is the counterpart of
the ``pre_encode`` branch of ``Text2ImageDataset`` (with the members named
after the encoder checkpoints renamed), ``Text2ImageDataset`` of its
raw-image branch (the native reader of ``native_io`` where it builds), and
``ClassificationDataset`` of the class-id shards of
``train_maskgit_imagenet``.
"""

from __future__ import annotations

import io
import itertools
import json
import logging
import os
import queue
import random
import re
import subprocess
import tarfile
import threading
from typing import Any, Callable, Dict, Iterable, Iterator, List, Optional

import numpy as np
import torch.distributed as dist

__all__ = ["braceexpand", "expand_urls", "tar_samples", "ShardSource", "decode_sample",
           "get_aesthetic_score", "person_token_replace", "image_transform",
           "sdxl_synthetic_dataset_map", "ds_clean_upscaled_map", "ds_clean_map", "DATASET_MAPS",
           "WebdatasetSelect", "PreEncodedDataset", "Text2ImageDataset", "ClassificationDataset"]

logger = logging.getLogger(__name__)

_BRACE_RE = re.compile(r"\{(\d+)\.\.(\d+)\}")


def braceexpand(pattern: str) -> List[str]:
    """'{00000..00004}.tar' -> 5 urls; several ranges and comma alternation
    '{a,b}' expand left to right, as bash does."""
    m_range = _BRACE_RE.search(pattern)
    m_alt = re.search(r"\{([^{}]*,[^{}]*)\}", pattern)
    if m_range and (m_alt is None or m_range.start() < m_alt.start()):
        lo, hi = m_range.group(1), m_range.group(2)
        out = []
        for i in range(int(lo), int(hi) + 1):
            out.extend(braceexpand(pattern[: m_range.start()] + str(i).zfill(len(lo))
                                   + pattern[m_range.end():]))
        return out
    if m_alt:
        out = []
        for alt in m_alt.group(1).split(","):
            out.extend(braceexpand(pattern[: m_alt.start()] + alt + pattern[m_alt.end():]))
        return out
    return [pattern]


def expand_urls(urls) -> List[str]:
    """str | list[str] with brace patterns -> a flat list of shards."""
    if isinstance(urls, str):
        urls = [urls]
    out = []
    for u in urls:
        out.extend(braceexpand(u))
    return out


def _open_shard(url: str):
    """A local path, or 'pipe:cmd ...' whose standard output is the tar."""
    if url.startswith("pipe:"):
        proc = subprocess.Popen(url[5:], shell=True, stdout=subprocess.PIPE, bufsize=1 << 20)
        return proc.stdout
    return open(url, "rb")


def tar_samples(url: str, handler: str = "warn") -> Iterator[Dict[str, bytes]]:
    """Stream key-grouped samples from one tar shard: members 'key.ext' group
    into {'__key__': key, '__url__': url, ext: bytes, ...}.  Unreadable
    members are skipped; a corrupt or truncated shard ends the stream with a
    warning unless ``handler == "raise"``."""
    try:
        stream = _open_shard(url)
    except OSError:
        if handler == "raise":
            raise
        return
    current_key = None
    sample: Dict[str, Any] = {}
    try:
        with tarfile.open(fileobj=stream, mode="r|*") as tf:
            for member in tf:
                if not member.isfile():
                    continue
                name = member.name
                if name.startswith("./"):
                    name = name[2:]
                if "." not in name:
                    continue
                key, ext = name.split(".", 1)
                try:
                    data = tf.extractfile(member).read()
                except Exception:
                    continue
                if key != current_key:
                    if current_key is not None and sample:
                        yield sample
                    current_key = key
                    sample = {"__key__": key, "__url__": url}
                sample[ext.lower()] = data
            if current_key is not None and sample:
                yield sample
    except (tarfile.TarError, EOFError, OSError) as e:
        if handler == "raise":
            raise
        logger.warning("skipping corrupt shard %s: %s", url, e)
    finally:
        try:
            stream.close()
        except Exception:
            pass


def _process(process_index: Optional[int], process_count: Optional[int]) -> dict:
    """This process's rank and the rank count: the given ones, else the
    ``torch.distributed`` group's (rank 0 of 1 without one)."""
    rank, world = (dist.get_rank(), dist.get_world_size()) if dist.is_initialized() else (0, 1)
    return {"process_index": rank if process_index is None else process_index,
            "process_count": world if process_count is None else process_count}


class ShardSource:
    """This process's share of the shards (every ``process_count``-th from
    ``process_index``), resampled with replacement forever
    (``resample=True``) or walked once, optionally shuffled."""

    def __init__(self, urls, *, process_index: int, process_count: int, shuffle: bool = True,
                 resample: bool = True, seed: Optional[int] = None):
        # a bare dataset name resolves to a shard-list YAML in configs/
        if isinstance(urls, str) and "." not in os.path.basename(urls):
            repo_configs = os.path.join(os.path.dirname(os.path.dirname(
                os.path.dirname(os.path.abspath(__file__)))), "configs")
            for base in (os.path.join(os.getcwd(), "configs"), repo_configs):
                candidate = os.path.join(base, f"{urls}.yaml")
                if os.path.isfile(candidate):
                    import yaml

                    with open(candidate) as f:
                        urls = yaml.safe_load(f)
                    break
        self.urls = expand_urls(urls)[process_index::max(1, process_count)]
        if not self.urls:
            raise ValueError(f"no shards for process {process_index} of {process_count}")
        self.shuffle = shuffle
        self.resample = resample
        self.rng = random.Random(seed)

    def __iter__(self) -> Iterator[str]:
        if self.resample:
            while True:
                yield self.rng.choice(self.urls)
        else:
            urls = list(self.urls)
            if self.shuffle:
                self.rng.shuffle(urls)
            yield from urls


_IMG_EXTS = ("jpg", "jpeg", "png", "webp")


def decode_sample(sample: Dict[str, bytes], pre_encoded: bool = False) -> Dict[str, Any]:
    """Raw members -> 'image' (PIL RGB), 'text', 'metadata', 'class_id', and
    with ``pre_encoded`` every '.npy' / '.pth' member as an array."""
    out = {"__key__": sample.get("__key__")}
    for ext, data in sample.items():
        if ext.startswith("__"):
            continue
        if ext in _IMG_EXTS:
            from PIL import Image

            out["image"] = Image.open(io.BytesIO(data)).convert("RGB")
        elif ext in ("txt", "text", "caption"):
            out["text"] = data.decode("utf-8")
        elif ext == "json":
            out["metadata"] = json.loads(data)
        elif ext.endswith("pth") and pre_encoded:
            import torch

            out[ext] = torch.load(io.BytesIO(data), map_location="cpu", weights_only=True)
        elif ext.endswith("npy") and pre_encoded:
            out[ext] = np.load(io.BytesIO(data))
        elif ext == "cls":
            out["class_id"] = int(data.decode("utf-8"))
    return out


def get_aesthetic_score(meta: Dict[str, Any]) -> float:
    """The aesthetic score across the LAION / COYO / stability metadata
    dialects; 0.0 when there is none."""
    if "aesthetic" in meta:
        a = meta["aesthetic"]
    elif "AESTHETIC_SCORE" in meta:
        a = meta["AESTHETIC_SCORE"]
    elif "aesthetic_score_laion_v2" in meta:
        a = meta["aesthetic_score_laion_v2"]
    elif "stability_metadata" in meta and "aes_scorelv2" in meta["stability_metadata"]:
        a = meta["stability_metadata"]["aes_scorelv2"]
    else:
        a = 0.0
    return float(a)


def person_token_replace(text: str, rng: random.Random) -> str:
    """CC12M's '<person>' tokens -> a person word drawn from ``rng``."""
    person_words = ["a person", "someone", "somebody"]
    while "<person>" in text:
        text = text.replace("<person>", rng.choice(person_words), 1)
    return text


def image_transform(image, resolution: int = 256, rng: Optional[random.Random] = None,
                    center_crop: bool = False, normalize: bool = True):
    """Resize the shorter side to ``resolution`` (bilinear), crop a square
    (centred or at random) -> (NHWC array, float in [0, 1] or uint8 with
    ``normalize=False``; orig_size (width, height); crop_coords (top,
    left))."""
    from PIL import Image

    rng = rng or random
    w, h = image.size
    orig_size = (w, h)
    scale = resolution / min(w, h)
    image = image.resize((max(resolution, round(w * scale)),
                          max(resolution, round(h * scale))), Image.BILINEAR)
    w2, h2 = image.size
    if center_crop:
        left, top = (w2 - resolution) // 2, (h2 - resolution) // 2
    else:
        left = rng.randint(0, w2 - resolution) if w2 > resolution else 0
        top = rng.randint(0, h2 - resolution) if h2 > resolution else 0
    image = image.crop((left, top, left + resolution, top + resolution))
    if normalize:
        arr = np.asarray(image, dtype=np.float32) / 255.0
    else:
        arr = np.asarray(image, dtype=np.uint8)
    return arr, orig_size, (top, left)


def sdxl_synthetic_dataset_map(sample: Dict[str, bytes]) -> Dict[str, bytes]:
    """SDXL-synthetic shards: N candidate images ``<key>.<i>.png`` and
    ``clip_scores.txt``; the best-scoring candidate is kept, with metadata
    of its 1024 px generation and an aesthetic score of 5."""
    scores = [float(x) for x in sample["clip_scores.txt"].decode("utf-8").split(",")]
    best_key = f"{max(range(len(scores)), key=scores.__getitem__)}.png"
    if best_key not in sample:
        raise ValueError(f"{best_key} not found in sample; expected files <key>.<i>.png "
                         f"matching the clip_scores.txt indices")
    return {"__key__": sample.get("__key__"), "__url__": sample.get("__url__"),
            "txt": sample["txt"], "png": sample[best_key],
            "json": json.dumps({"aesthetic": 5, "original_width": 1024,
                                "original_height": 1024}).encode()}


def _png(data: bytes):
    from PIL import Image

    with io.BytesIO(data) as stream:
        image = Image.open(stream)
        image.load()
    return image


def ds_clean_upscaled_map(sample: Dict[str, bytes]) -> Dict[str, bytes]:
    """ds_clean's upscaled variant: the image's own size as the original
    size, an aesthetic score of 5."""
    image = _png(sample["png"])
    return {"__key__": sample.get("__key__"), "__url__": sample.get("__url__"),
            "txt": sample["txt"], "png": sample["png"],
            "json": json.dumps({"aesthetic": 5, "original_width": image.width,
                                "original_height": image.height}).encode()}


def ds_clean_map(sample: Dict[str, bytes]) -> Dict[str, bytes]:
    """ds_clean's 2 x 2 grids: the top-left quadrant, re-encoded as PNG."""
    image = _png(sample["png"])
    width, height = image.width // 2, image.height // 2
    buf = io.BytesIO()
    image.crop((0, 0, width, height)).save(buf, format="PNG")
    return {"__key__": sample.get("__key__"), "__url__": sample.get("__url__"),
            "txt": sample["txt"], "png": buf.getvalue(),
            "json": json.dumps({"aesthetic": 5, "original_width": width,
                                "original_height": height}).encode()}


DATASET_MAPS = {"sdxl_synthetic": sdxl_synthetic_dataset_map, "ds_clean": ds_clean_map,
                "ds_clean_upscaled": ds_clean_upscaled_map}


class WebdatasetSelect:
    """Metadata quality filter across the LAION / COYO metadata dialects: min
    size, watermark probability, aesthetic score, nsfw, spawning opt-out,
    getty."""

    def __init__(self, min_size: int = 256, max_pwatermark: float = 0.5,
                 min_aesthetic_score: float = 4.75,
                 require_marked_as_ok_by_spawning: bool = False,
                 require_marked_as_not_getty: bool = False, max_pnsfw: Optional[float] = None):
        self.min_size = min_size
        self.max_pwatermark = max_pwatermark
        self.min_aesthetic_score = min_aesthetic_score
        self.require_marked_as_ok_by_spawning = require_marked_as_ok_by_spawning
        self.require_marked_as_not_getty = require_marked_as_not_getty
        self.max_pnsfw = max_pnsfw

    def __call__(self, sample: Dict[str, Any]) -> bool:
        meta = sample.get("metadata")
        if meta is None:
            return False
        w = meta.get("width", meta.get("WIDTH", meta.get("original_width")))
        h = meta.get("height", meta.get("HEIGHT", meta.get("original_height")))
        if w is None or h is None or w < self.min_size or h < self.min_size:
            return False
        pw = meta.get("pwatermark", meta.get("watermark_score"))
        if pw is not None and pw > self.max_pwatermark:
            return False
        aes = meta.get("aesthetic", meta.get("AESTHETIC_SCORE", meta.get("aesthetic_score")))
        if aes is not None and aes < self.min_aesthetic_score:
            return False
        nsfw = meta.get("pnsfw", meta.get("punsafe", meta.get("nsfw_score")))
        if self.max_pnsfw is not None and nsfw is not None and nsfw > self.max_pnsfw:
            return False
        if self.require_marked_as_ok_by_spawning and meta.get("optout", False):
            return False
        if self.require_marked_as_not_getty and "getty" in str(meta.get("url", "")).lower():
            return False
        return True


def _prefetch(iterator: Iterable, depth: int = 4) -> Iterator:
    """Run ``iterator`` in a background thread, ``depth`` items ahead."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    sentinel = object()

    def worker():
        try:
            for item in iterator:
                q.put(item)
        finally:
            q.put(sentinel)

    threading.Thread(target=worker, daemon=True).start()
    while True:
        item = q.get()
        if item is sentinel:
            return
        yield item


def _shuffled(samples, buffer_size: int, rng: random.Random) -> Iterator:
    """``samples`` through a shuffle buffer of ``buffer_size``."""
    buf: List[Any] = []
    for sample in samples:
        if len(buf) < buffer_size:
            buf.append(sample)
            continue
        idx = rng.randrange(len(buf))
        yield buf[idx]
        buf[idx] = sample
    rng.shuffle(buf)
    yield from buf


class PreEncodedDataset:
    """Yields dicts of stacked numpy arrays, one entry per ``.npy`` / ``.pth``
    member (``vq_f16.npy``, ``clip_penultimate.npy``, ``clip_pooled.npy``, ...)
    plus ``__keys__``, from shards resampled with replacement (or walked
    once with ``resample=False``); ``select`` filters on the decoded sample
    (its ``metadata``).  The reference's dialect names members after the
    encoder checkpoints that wrote them: ``<vae_checkpoint>.pth`` becomes
    ``image_input_ids`` and ``<text_encoder_checkpoint>.pth``
    ``encoder_hidden_states`` (each name lower-cased, ``/`` as ``.``).  The
    shards are split by rank (``process_index`` / ``process_count``, by
    default the ``torch.distributed`` group's; rank 0 of 1 without one)."""

    def __init__(self, train_shards_path_or_url, batch_size: int, *,
                 shuffle_buffer_size: int = 1000, select: Optional[Callable] = None,
                 resample: bool = True, seed: int = 0, vae_checkpoint: Optional[str] = None,
                 text_encoder_checkpoint: Optional[str] = None,
                 process_index: Optional[int] = None, process_count: Optional[int] = None):
        self.shards = ShardSource(train_shards_path_or_url, resample=resample, seed=seed,
                                  **_process(process_index, process_count))
        self.batch_size = batch_size
        self.shuffle_buffer_size = shuffle_buffer_size
        self.select = select
        self.rng = random.Random(seed + 1)
        self.renames = {f"{name.lower().replace('/', '.')}.pth": canonical
                        for name, canonical in ((vae_checkpoint, "image_input_ids"),
                                                (text_encoder_checkpoint,
                                                 "encoder_hidden_states")) if name}

    def _samples(self) -> Iterator[Dict[str, Any]]:
        for url in self.shards:
            try:
                for raw in tar_samples(url, handler="raise"):
                    sample = decode_sample(raw, pre_encoded=True)
                    if self.select is None or self.select(sample):
                        yield sample
            except (tarfile.TarError, EOFError, OSError) as exc:
                logger.warning("skipping corrupt shard %s: %s", url, exc)

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        batch: List[Dict[str, Any]] = []
        for sample in _prefetch(_shuffled(self._samples(), self.shuffle_buffer_size, self.rng)):
            batch.append(sample)
            if len(batch) == self.batch_size:
                yield self._collate(batch)
                batch = []

    def _collate(self, batch: List[Dict[str, Any]]) -> Dict[str, Any]:
        out: Dict[str, Any] = {"__keys__": [s["__key__"] for s in batch]}
        for k in batch[0]:
            if k.endswith("npy") or k.endswith("pth"):
                out[self.renames.get(k, k)] = np.stack([np.asarray(s[k]) for s in batch])
        return out


class Text2ImageDataset:
    """Raw text-to-image batches: dicts of ``pixel_values`` (B, R, R, 3)
    float in [0, 1] (the shorter side resized to R, a square cropped at
    random, or centred with ``center_crop``), ``input_text`` (a list),
    ``orig_sizes`` (B, 2) (width, height; the metadata's original size where
    it has one), ``crop_coords`` (B, 2) (top, left) and ``aesthetic_scores``
    (B,), from shards resampled with replacement (or walked once with
    ``resample=False``), filtered by ``select`` on the decoded sample.  The
    crops, shuffles and person words come from one ``random.Random(seed +
    1)``, as in the JAX dataset.  ``dataset_map`` (a name in
    ``DATASET_MAPS`` or a callable) rewrites each raw sample first (a
    sample it fails on is skipped with a warning; ``sdxl_synthetic`` skips
    samples without ``clip_scores.txt``).  A sample without an image is
    skipped, and one without a caption too unless ``require_text`` is
    False.  ``use_native``: the shards are read by ``native_io``'s C++
    threads, 16 sampled shards at a time, where the library builds, else
    by the Python reader (the log says which).  The shards are split by rank
    as ``PreEncodedDataset``'s."""

    def __init__(self, train_shards_path_or_url, batch_size: int, *, resolution: int = 256,
                 shuffle_buffer_size: int = 1000, select: Optional[Callable] = None,
                 resample: bool = True, seed: int = 0, center_crop: bool = False,
                 prefetch_depth: int = 4, require_text: bool = True,
                 dataset_map: Optional[Any] = None, use_native: bool = True,
                 native_threads: int = 4, process_index: Optional[int] = None,
                 process_count: Optional[int] = None):
        self.shards = ShardSource(train_shards_path_or_url, resample=resample, seed=seed,
                                  **_process(process_index, process_count))
        self.batch_size = batch_size
        self.resolution = resolution
        self.shuffle_buffer_size = shuffle_buffer_size
        self.select = select
        self.center_crop = center_crop
        self.prefetch_depth = prefetch_depth
        self.require_text = require_text
        self.dataset_map = DATASET_MAPS[dataset_map] if isinstance(dataset_map, str) \
            else dataset_map
        self.use_native = use_native
        self.native_threads = native_threads
        self.rng = random.Random(seed + 1)

    def _raw_samples(self) -> Iterator[Dict[str, bytes]]:
        if self.use_native:
            from .native_io import NativeShardReader, native_available

            if native_available():
                logger.info("reading shards with the native reader (%d threads)",
                            self.native_threads)
                # the sampled urls go to the C++ pool in chunks, so that
                # resampling with replacement keeps its meaning
                shard_iter = iter(self.shards)
                while True:
                    chunk = list(itertools.islice(shard_iter, 16))
                    if not chunk:
                        return
                    with NativeShardReader(chunk, num_threads=self.native_threads) as reader:
                        yield from reader
        logger.info("reading shards with the Python reader")
        for url in self.shards:
            yield from tar_samples(url)

    def _samples(self) -> Iterator[Dict[str, Any]]:
        for raw in self._raw_samples():
            if self.dataset_map is not None:
                if self.dataset_map is sdxl_synthetic_dataset_map and \
                        "clip_scores.txt" not in raw:
                    continue
                try:
                    raw = self.dataset_map(raw)
                except Exception as exc:  # warn and continue, as webdataset's handler
                    logger.warning("dataset_map failed on %s: %s", raw.get("__key__"), exc)
                    continue
            sample = decode_sample(raw)
            if "image" not in sample or (self.require_text and "text" not in sample):
                continue
            if self.select is None or self.select(sample):
                yield sample

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        it = _shuffled(self._samples(), self.shuffle_buffer_size, self.rng)
        if self.prefetch_depth:
            it = _prefetch(it, self.prefetch_depth)
        batch: List[Dict[str, Any]] = []
        for sample in it:
            batch.append(sample)
            if len(batch) == self.batch_size:
                yield self._collate(batch)
                batch = []

    def _collate(self, batch: List[Dict[str, Any]]) -> Dict[str, Any]:
        pixels, texts, orig_sizes, crops, aes = [], [], [], [], []
        for s in batch:
            arr, orig, crop = image_transform(s["image"], self.resolution, self.rng,
                                              self.center_crop)
            pixels.append(arr)
            texts.append(person_token_replace(s.get("text", ""), self.rng))
            meta = s.get("metadata") or {}
            if "original_width" in meta and "original_height" in meta:
                orig = (int(meta["original_width"]), int(meta["original_height"]))
            orig_sizes.append(orig)
            crops.append(crop)
            aes.append(get_aesthetic_score(meta))
        return {"pixel_values": np.stack(pixels), "input_text": texts,
                "orig_sizes": np.asarray(orig_sizes, dtype=np.float32),
                "crop_coords": np.asarray(crops, dtype=np.float32),
                "aesthetic_scores": np.asarray(aes, dtype=np.float32)}


class ClassificationDataset(Text2ImageDataset):
    """ImageNet-style class-id shards: batches of ``pixel_values`` (B, R, R,
    3) float in [0, 1] and ``class_ids`` (B,) int32 (a sample's ``.cls``
    member, 0 without one), and with ``imagenet_class_mapping_path`` (a
    json of class id -> text) ``input_text`` too.  Captions are not
    required; crops and shuffles as ``Text2ImageDataset``'s."""

    def __init__(self, *args, imagenet_class_mapping_path: Optional[str] = None, **kwargs):
        kwargs.setdefault("require_text", False)
        super().__init__(*args, **kwargs)
        self.class_mapping = None
        if imagenet_class_mapping_path:
            with open(imagenet_class_mapping_path) as f:
                self.class_mapping = json.load(f)

    def _collate(self, batch: List[Dict[str, Any]]) -> Dict[str, Any]:
        pixels, class_ids, texts = [], [], []
        for s in batch:
            arr, _, _ = image_transform(s["image"], self.resolution, self.rng, self.center_crop)
            pixels.append(arr)
            cid = int(s.get("class_id", 0))
            class_ids.append(cid)
            if self.class_mapping is not None:
                texts.append(self.class_mapping.get(str(cid), str(cid)))
        out = {"pixel_values": np.stack(pixels), "class_ids": np.asarray(class_ids, dtype=np.int32)}
        if texts:
            out["input_text"] = texts
        return out
