"""ViTVQGAN model stack of the port."""
