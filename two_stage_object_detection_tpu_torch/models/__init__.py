"""Backbones."""
