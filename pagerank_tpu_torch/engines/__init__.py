"""Engines of the port: the CUDA/CPU ELL engine and the f64 oracle."""
