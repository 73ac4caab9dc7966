"""Training: losses, schedules, optimizers and the ViTVQGAN GAN trainer."""
