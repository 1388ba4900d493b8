"""Models: patch embedding, nViT blocks, the ViT classifier, presets."""
