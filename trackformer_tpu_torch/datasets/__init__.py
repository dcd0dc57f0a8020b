"""Datasets and their evaluation (so far the box COCO evaluator)."""
