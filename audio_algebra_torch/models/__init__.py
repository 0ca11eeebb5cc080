"""Models of the port: blocks, SoundStream encoder, UNet, DVAE."""
