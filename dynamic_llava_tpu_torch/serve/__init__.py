"""Serving entry points of the port: the chat CLI, the HTTP controller, the
model worker, the batched / continuous worker and the Gradio front end."""
