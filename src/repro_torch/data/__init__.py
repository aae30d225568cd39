from .pipeline import SyntheticLM, batch_at
