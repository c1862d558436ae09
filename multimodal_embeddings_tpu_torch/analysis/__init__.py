"""Host-side analysis: the Qwen2.5-VL document parser."""
