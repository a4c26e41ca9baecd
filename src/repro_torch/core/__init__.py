"""OLA-RAW core on PyTorch: estimators, queries, engine, synopsis, controller."""
