"""DiffuEraser: SD1.5 + BrushNet + motion modules + PCM sampling."""
