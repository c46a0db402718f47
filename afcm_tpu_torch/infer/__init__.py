"""Serving side of the port: the patch-stitching predictor (the port's own
copy of ``afcm_tpu/infer/predictor.py``)."""

from .predictor import StandardPredictor, get_predictor, remove_halo

__all__ = ["StandardPredictor", "get_predictor", "remove_halo"]
