"""Host-side analysis: similarity, clustering, comparisons, reports, and the
Qwen2.5-VL document parser. Modules are imported where they are used."""
