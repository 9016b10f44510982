"""Model families (decoder, ssm, hybrid, image), their layers and the
family registry."""
