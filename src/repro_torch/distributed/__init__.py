"""Distribution: the train and serve step factories (``steps``), the
activation-sharding context (``ctx``), the sharding rules (``sharding``), the
per-device cost walker (``hlo_walk``) and the roofline terms (``analysis``)."""
