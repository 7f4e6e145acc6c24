from prompt_diffusion_tpu_torch.serving.server import (
    GenerationRequest,
    GenerationServer,
    PipelineAdapter,
    SD3Adapter,
    SD3GenerationRequest,
    SD15Adapter,
    ServerConfig,
    ServerStopped,
)

__all__ = [
    "GenerationRequest",
    "GenerationServer",
    "PipelineAdapter",
    "SD3Adapter",
    "SD3GenerationRequest",
    "SD15Adapter",
    "ServerConfig",
    "ServerStopped",
]
