"""The optimizer (``adamw``) and gradient compression with error feedback
(``compression``)."""
