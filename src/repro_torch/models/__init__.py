"""Model families (decoder so far), their layers and the family registry."""
