"""Core wavelength-arbitration library: the paper's LtC main path."""
