"""Image quality: FID over CLIP or InceptionV3 features, the CLIP score
and the Inception Score, the counterparts of ``open_muse_tpu/eval``."""

from .clip_score import clip_score
from .fid import (CLIPFeatureExtractor, compute_statistics, fid_between_dirs,
                  fid_between_image_sets, frechet_distance)
from .inception_score import inception_score, inception_score_from_logits

__all__ = ["frechet_distance", "compute_statistics", "fid_between_dirs",
           "fid_between_image_sets", "CLIPFeatureExtractor", "clip_score",
           "inception_score", "inception_score_from_logits"]
