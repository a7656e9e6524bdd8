"""Analytic roofline terms of a model configuration."""
