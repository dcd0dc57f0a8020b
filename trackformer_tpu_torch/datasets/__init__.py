"""Datasets and their evaluation: the box COCO evaluator, the eval-time
transforms, frame reading and the tracking sequences (`tracking/`)."""
