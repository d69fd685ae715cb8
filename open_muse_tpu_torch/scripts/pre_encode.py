"""Pre-encode webdataset shards for training: VQ tokens and CLIP embeddings.

Counterpart of ``scripts/pre_encode.py``: reads raw image + caption tar
shards, runs the tokenizers' ``get_code`` (``--vae-f16`` and ``--vae-f8``,
each a taming ``VQGANModel``, ``MaskGitVQGAN``, ``MOVQ`` or
``PaellaVQModel`` by its config's ``_class_name``; the ``vq_argmin`` kernel
on the card) and the CLIP text tower, and writes per sample the members
``vq_f16.npy`` / ``vq_f8.npy`` int32 (H*W,), ``clip_penultimate.npy`` fp16
(T, D), ``clip_pooled.npy`` fp16 (P,), plus the sample's ``.txt`` and ``.json``,
into tar shards of the same names, which ``training.data.PreEncodedDataset``
reads.  Models load in fp32 on ``--device`` (``cuda`` unless asked for
``cpu``).  Without ``--task-id`` / ``--num-tasks`` the process takes the
share of its rank under a launcher (``RANK`` / ``WORLD_SIZE``, as
``scripts/launch.py --module open_muse_tpu_torch.scripts.pre_encode`` starts
it, on the card of its ``LOCAL_RANK``), else every shard (rank 0 of 1).

    python -m open_muse_tpu_torch.scripts.pre_encode \\
        --shards 'data/{00000..00099}.tar' --output-dir encoded/ \\
        --vae-f16 path/to/vqgan [--vae-f8 path/to/paella] --text-encoder path/to/clip \\
        [--batch-size 64] [--resolution 256] [--task-id 0 --num-tasks 8] \\
        [--device cpu]
"""

from __future__ import annotations

import argparse
import io
import json
import os
import queue
import random
import tarfile
import threading
import time

import numpy as np
import torch

from ..core.configuration import load_config_dict
from ..core.modeling import resolve_device
from ..models.clip_text import CLIPTextEncoder, SimpleTokenizer
from ..pipelines.pipeline_muse import _VAE_CLASSES
from ..training.data import decode_sample, expand_urls, image_transform, tar_samples

__all__ = ["task_share", "distribute_shards", "ShardWriterPool", "has_tokenizer_files",
           "load_tokenizer", "to_device", "main"]

_TOKENIZER_FILES = ("tokenizer.json", "tokenizer_config.json", "vocab.json")


def task_share(task_id=None, num_tasks=None):
    """(task id, task count): the given ones, else the launcher's rank and
    world size (``RANK`` / ``WORLD_SIZE``), else task 0 of 1."""
    if task_id is not None and num_tasks:
        return task_id, num_tasks
    return int(os.environ.get("RANK", 0)), int(os.environ.get("WORLD_SIZE", 1))


def distribute_shards(shards, task_id: int, num_tasks: int):
    """A contiguous share of the shards for task ``task_id`` of ``num_tasks``."""
    per = (len(shards) + num_tasks - 1) // num_tasks
    return shards[task_id * per:(task_id + 1) * per]


class ShardWriterPool:
    """Writes tar shards from background threads: at most ``max_open``
    shards open at once (the oldest is closed first), one queue per shard;
    a path may be 'pipe:cmd', whose standard input takes the tar."""

    def __init__(self, output_pattern: str, max_open: int = 4):
        self.output_pattern = output_pattern
        self.max_open = max_open
        self.queues = {}
        self.threads = {}
        self.closed = set()
        self.errors = []
        self.lock = threading.Lock()

    def _writer_loop(self, shard_name: str, q: "queue.Queue"):
        path = self.output_pattern.format(shard=shard_name)
        try:
            if path.startswith("pipe:"):
                import subprocess

                proc = subprocess.Popen(path[5:], shell=True, stdin=subprocess.PIPE)
                stream = proc.stdin
            else:
                os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
                stream = open(path, "wb")
            with tarfile.open(fileobj=stream, mode="w|") as tf:
                while True:
                    item = q.get()
                    if item is None:
                        break
                    name, data = item
                    info = tarfile.TarInfo(name)
                    info.size = len(data)
                    info.mtime = int(time.time())
                    tf.addfile(info, io.BytesIO(data))
            stream.close()
        except Exception as e:  # reported by close()
            self.errors.append((shard_name, e))

    def submit(self, shard_name: str, members: dict):
        with self.lock:
            if shard_name not in self.queues:
                if shard_name in self.closed:
                    # reopening would truncate the tar: shards are written contiguously
                    raise RuntimeError(f"shard {shard_name} was already finalized; raise "
                                       f"max_open or write shards contiguously")
                if len(self.queues) >= self.max_open:
                    self._close(next(iter(self.queues)))
                q = queue.Queue(maxsize=256)
                t = threading.Thread(target=self._writer_loop, args=(shard_name, q),
                                     daemon=True)
                t.start()
                self.queues[shard_name] = q
                self.threads[shard_name] = t
        for name, data in members.items():
            self.queues[shard_name].put((name, data))

    def _close(self, shard_name: str):
        q = self.queues.pop(shard_name)
        t = self.threads.pop(shard_name)
        self.closed.add(shard_name)
        q.put(None)
        t.join()

    def close(self):
        for shard_name in list(self.queues):
            self._close(shard_name)
        if self.errors:
            raise RuntimeError(f"writer errors: {self.errors}")


def _npy_bytes(arr) -> bytes:
    buf = io.BytesIO()
    np.save(buf, np.asarray(arr))
    return buf.getvalue()


def load_vae(path: str, device):
    """The tokenizer of a checkpoint directory, by the ``_class_name`` of its
    config: a taming ``VQGANModel``, a ``MaskGitVQGAN``, a ``MOVQ`` or a
    ``PaellaVQModel``."""
    class_name = load_config_dict(path).get("_class_name", "VQGANModel")
    if class_name not in _VAE_CLASSES:
        raise ValueError(f"unknown VQ model class {class_name!r} at {path}")
    return _VAE_CLASSES[class_name].from_pretrained(path, device=device).eval()


def has_tokenizer_files(path: str) -> bool:
    return any(os.path.isfile(os.path.join(path, name)) for name in _TOKENIZER_FILES)


def load_tokenizer(path: str, text_encoder: CLIPTextEncoder):
    """``transformers.AutoTokenizer`` where the directory holds tokenizer
    files, else the port's hash ``SimpleTokenizer`` at the tower's sizes."""
    if has_tokenizer_files(path):
        from transformers import AutoTokenizer

        return AutoTokenizer.from_pretrained(path, local_files_only=True)
    cfg = text_encoder.config
    return SimpleTokenizer(cfg.vocab_size, cfg.max_position_embeddings)


def _batches(shards, batch_size: int):
    """(shard name, decoded samples with an image), ``batch_size`` at a time;
    a shard's last batch may be shorter."""
    for url in shards:
        shard_name, batch = os.path.basename(url), []
        for raw in tar_samples(url):
            sample = decode_sample(raw)
            if "image" in sample:
                batch.append(sample)
            if len(batch) == batch_size:
                yield shard_name, batch
                batch = []
        if batch:
            yield shard_name, batch


def to_device(array, device) -> torch.Tensor:
    """A host array on ``device``.  To the card it goes from pinned memory
    and without waiting, so the copy queues behind the batch before it
    instead of holding the host until that batch is done."""
    tensor = torch.from_numpy(np.ascontiguousarray(array))
    if device.type != "cuda":
        return tensor
    return tensor.pin_memory().to(device, non_blocking=True)


def _to_host(outs, device):
    """Queue the copies of a batch's outputs into host memory; returns the
    host tensors and the event that marks their arrival (None on the CPU)."""
    if device.type != "cuda":
        return outs, None
    host = {name: torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t, non_blocking=True)
            for name, t in outs.items()}
    done = torch.cuda.Event()
    done.record()
    return host, done


@torch.no_grad()
def _encode_batch(batch, resolution: int, vaes, text_encoder, tokenizer, device):
    """Host transform, then the encoders on ``device`` and the copies of
    their outputs to the host, all queued: returns ``_to_host``'s host
    tensors and event, which ``_write_batch`` waits on."""
    rng = random.Random(0)
    pixels = np.stack([image_transform(sample["image"], resolution, rng, center_crop=True,
                                       normalize=False)[0] for sample in batch])
    outs = {}
    if vaes:
        # uint8 to the device, 4x fewer bytes than fp32; normalised there
        images = to_device(pixels, device).float() / 255.0
        for name, vae in vaes.items():
            outs[name] = vae.get_code(images).to(torch.int32)
    if text_encoder is not None:
        texts = [sample.get("text", "") for sample in batch]
        ids = tokenizer(texts, padding="max_length", truncation=True,
                        max_length=tokenizer.model_max_length, return_tensors="np")["input_ids"]
        hidden_states, _, pooled = text_encoder(to_device(np.asarray(ids, np.int64), device))
        outs["clip_penultimate.npy"] = hidden_states[-2].to(torch.float16)
        outs["clip_pooled.npy"] = pooled.to(torch.float16)
    return _to_host(outs, device)


def _write_batch(batch, shard_name, host, done, writer):
    """Wait for this batch's outputs alone and hand each sample's members to
    the writer."""
    if done is not None:
        done.synchronize()
    host = {name: t.numpy() for name, t in host.items()}
    for i, sample in enumerate(batch):
        key = sample["__key__"]
        members = {f"{key}.{name}": _npy_bytes(arr[i]) for name, arr in host.items()}
        if "text" in sample:
            members[f"{key}.txt"] = sample["text"].encode()
        if "metadata" in sample:
            members[f"{key}.json"] = json.dumps(sample["metadata"]).encode()
        writer.submit(shard_name, members)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--shards", required=True)
    parser.add_argument("--output-dir", required=True)
    parser.add_argument("--vae-f16", help="dir of a VQ model checkpoint (vq_f16.npy)")
    parser.add_argument("--vae-f8", help="dir of a Paella f8 checkpoint (vq_f8.npy)")
    parser.add_argument("--text-encoder", help="dir of a CLIP text encoder")
    parser.add_argument("--batch-size", type=int, default=64)
    parser.add_argument("--resolution", type=int, default=256)
    parser.add_argument("--task-id", type=int, default=None)
    parser.add_argument("--num-tasks", type=int, default=None)
    parser.add_argument("--max-batches", type=int, default=None)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    device = resolve_device(args.device)
    if device.type == "cuda" and "LOCAL_RANK" in os.environ:
        device = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
        torch.cuda.set_device(device)
    vaes = {f"vq_{kind}.npy": load_vae(path, device)
            for kind, path in (("f16", args.vae_f16), ("f8", args.vae_f8)) if path}
    text_encoder = tokenizer = None
    if args.text_encoder:
        text_encoder = CLIPTextEncoder.from_pretrained(args.text_encoder, device=device).eval()
        tokenizer = load_tokenizer(args.text_encoder, text_encoder)

    task_id, num_tasks = task_share(args.task_id, args.num_tasks)
    shards = distribute_shards(expand_urls(args.shards), task_id, num_tasks)
    writer = ShardWriterPool(os.path.join(args.output_dir, "{shard}"))

    t_start = time.time()
    n_samples = n_batches = first = 0
    t_steady = None
    # one batch in flight: batch N's kernels and copies are queued, then the
    # host writes batch N - 1 (waiting on that batch's event alone) and
    # decodes batch N + 1 while the device encodes batch N
    pending = None
    for shard_name, batch in _batches(shards, args.batch_size):
        host, done = _encode_batch(batch, args.resolution, vaes, text_encoder, tokenizer, device)
        if pending is not None:
            _write_batch(*pending, writer)
        pending = (batch, shard_name, host, done)
        n_batches += 1
        n_samples += len(batch)
        if n_batches == 1:  # the steady window starts after the first batch's warm-up
            t_steady, first = time.perf_counter(), len(batch)
        if args.max_batches and n_batches >= args.max_batches:
            break
    if pending is not None:
        _write_batch(*pending, writer)
    writer.close()
    dt = time.time() - t_start
    stats = {"n_samples": n_samples, "n_batches": n_batches, "total_s": dt,
             "imgs_per_sec": n_samples / max(dt, 1e-9)}
    if n_batches > 1 and t_steady is not None:
        stats["steady_imgs_per_sec"] = ((n_samples - first)
                                        / max(time.perf_counter() - t_steady, 1e-9))
    print(f"encoded {n_samples} samples from {len(shards)} shards on {device} in {dt:.1f}s "
          f"({stats['imgs_per_sec']:.1f} samples/s"
          + (f"; {stats['steady_imgs_per_sec']:.1f} samples/s after the first batch"
             if "steady_imgs_per_sec" in stats else "") + ")")
    return stats


if __name__ == "__main__":
    main()
