"""The training path: step builders (``train.steps``) and the loop with
checkpoint/restart fault tolerance (``train.loop``) — ports of
``repro/train``."""
