"""Launch plane (counterpart of ``repro.launch``): the production mesh,
the model cells, the sharded OLA-verify cell, the train and serve entry
points."""
