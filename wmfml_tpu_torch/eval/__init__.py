"""Statistical evaluation of trained models (the loss-vs-context sweep)."""
