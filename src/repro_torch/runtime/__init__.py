"""The fault-tolerant training runtime (``trainer``)."""
