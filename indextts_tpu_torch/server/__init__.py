"""The web server of the PyTorch engine: webui.create_app / main (console
script indextts-tpu-torch-server) on the stdlib WSGI layer of wsgi.py."""
