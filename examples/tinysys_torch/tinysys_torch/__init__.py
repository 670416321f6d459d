"""tinysys_torch — the tinysys application on the PyTorch port.

The twin of ``examples/tinysys/tinysys``: a classifier aggregate built by a
compiler pipeline, driven by a named service, observed by decoupled
consumers (logging, experiment tracking, TensorBoard), with identity-keyed
checkpoint/resume. Here the classifier is an ``nn.Module`` that trains on
one device through the port's eager step functions; everything else is the
same architecture.
"""
