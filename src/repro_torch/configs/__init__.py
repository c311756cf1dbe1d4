"""Named DWDM system configurations."""
