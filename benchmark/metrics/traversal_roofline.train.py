"""Percent of the measured traversal time of a training step that the least
time of its closest hits is (benchmark/roofline.py); nothing where the
unit had no traversal or its rays were not counted."""

from benchmark import roofline


def read(t):
    return roofline.share(t.get("roofline_unit"), t.get("traversal_ms"))
