"""Datasets and their evaluation: the training datasets (`coco`, `mot`,
`crowdhuman`) behind `build_dataset`, their transforms and batch
collation (`builder`), the box COCO evaluator, frame reading and the
tracking sequences (`tracking/`)."""
from .builder import build_dataset  # noqa: F401
