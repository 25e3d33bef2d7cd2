"""Model modules of the port (CLIP tower, projector, predictors, LLaMA, Dynamic-LLaVA)."""
