"""Train and serve step factories (``steps``)."""
