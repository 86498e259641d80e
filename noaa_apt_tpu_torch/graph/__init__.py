"""The decode pipeline (``decode``) and the image finish (``process``)."""
