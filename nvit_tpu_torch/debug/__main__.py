from nvit_tpu_torch.debug.cli import debug_model

if __name__ == "__main__":
    debug_model()
