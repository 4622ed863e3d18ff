"""Tensor ops of the port: display transforms, spectra and the curscan
kernels."""
